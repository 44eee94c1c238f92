"""Checkpoints of the port (ait_tpu_torch/train/checkpoint.py): the save ->
restore round trip of the model, the optimizer's state (SGD momentum, Adam
moments) and the step is bit-equal; `latest_step`, `max_to_keep`, `force`;
a half-written save is never taken for a checkpoint; a step after restore
(`make_train_step(start_step=)`) equals the same step on the saved objects
bit for bit, at the lr the schedule gives that step; `save_config` writes
JAX's bytes and `_config_from_json` reads them back as JAX's does."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from ait_tpu.config import Config as JaxConfig
from ait_tpu.predict import _config_from_json as jax_config_from_json
from ait_tpu.train.checkpoint import save_config as jax_save_config
from ait_tpu_torch.config import Config
from ait_tpu_torch.models import AITDetector
from ait_tpu_torch.predict import _config_from_json
from ait_tpu_torch.train import (init_weights, lr_schedule, make_optimizer,
                                 make_train_step)
from ait_tpu_torch.train.checkpoint import CheckpointManager, save_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on the CPU's
    cores, and each torch process would otherwise start one a core."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _tiny_cfg():
    cfg = Config()
    return cfg.replace(
        TRAIN=dataclasses.replace(cfg.TRAIN, RPN_PRE_NMS_TOP_N=64,
                                  RPN_POST_NMS_TOP_N=16, RPN_BATCHSIZE=16,
                                  BATCH_SIZE=8),
        MAX_NUM_GT_BOXES=4)


def _batch(seed=0, b=1, h=96, w=128):
    rng = np.random.RandomState(seed)
    gt = np.zeros((b, 4, 5), np.float32)
    gt[:, 0] = [8, 10, 70, 80, 1]
    return {"image": rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8),
            "query": rng.randint(0, 256, (b, 128, 128, 3)).astype(np.uint8),
            "im_info": np.tile(np.float32([[h - 8, w - 16, 1.0]]), (b, 1)),
            "gt_boxes": gt}


def _same_state(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _same_state(a[k], b[k])
        elif isinstance(a[k], (list, tuple)):
            assert len(a[k]) == len(b[k])
            for x, y in zip(a[k], b[k]):
                if isinstance(x, dict):
                    _same_state(x, y)
                else:
                    assert x == y, k
        elif isinstance(a[k], torch.Tensor):
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_round_trip_is_bit_equal(tmp_path, optimizer):
    """The full-width detector with optimizer state after two updates."""
    cfg = Config()
    model = init_weights(AITDetector(cfg), 0)
    opt = make_optimizer(cfg, model, optimizer=optimizer)
    for i in range(2):
        for g in opt.param_groups:
            for p in g["params"]:
                p.grad = p.detach() * (0.1 * i - 0.05) + 1e-3
        opt.step()
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.save(7, model, opt, metadata={"epoch": 2, "session": 1})

    model2 = AITDetector(cfg)                # zeros until restored
    opt2 = make_optimizer(cfg, model2, optimizer=optimizer)
    assert mgr.restore(model2, opt2) == (7, {"epoch": 2, "session": 1})
    _same_state(model.state_dict(), model2.state_dict())
    _same_state(opt.state_dict(), opt2.state_dict())
    assert opt2.state_dict()["state"], "no optimizer state restored"


def _small():
    m = torch.nn.Linear(3, 2)
    return m, torch.optim.SGD(m.parameters(), lr=0.1, momentum=0.9)


def test_latest_step_max_to_keep_and_force(tmp_path):
    m, opt = _small()
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.latest_step() is None and mgr.restore(m) is None
    assert mgr.save(3, m, opt)
    assert mgr.save(5, m, opt)
    assert not mgr.save(4, m, opt)           # not above the latest
    assert mgr.save(4, m, opt, force=True)   # forced below it
    assert mgr.all_steps() == [4, 5]         # 3 dropped: 2 kept
    with torch.no_grad():
        m.weight.add_(1.0)
    assert not mgr.save(5, m, opt, force=True)   # a saved step stays
    m2, _ = _small()
    assert mgr.restore(m2)[0] == 5
    assert not torch.equal(m2.weight, m.weight)
    assert mgr.restore(m2, step=4)[0] == 4
    assert mgr.latest_step() == 5


def test_half_written_save_is_ignored(tmp_path):
    m, opt = _small()
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.save(2, m, opt)
    # a save killed before its rename, and a step directory without its file
    tmp = tmp_path / ".tmp-9-12345"
    tmp.mkdir()
    torch.save({"step": 9}, tmp / "state.pt")
    (tmp_path / "11").mkdir()
    assert mgr.latest_step() == 2
    assert CheckpointManager(str(tmp_path)).latest_step() == 2
    assert tmp.exists()                      # a reader deletes nothing
    assert mgr.save(3, m, opt)
    assert not tmp.exists()                  # the writer cleans up
    assert mgr.all_steps() == [2, 3]


def test_restore_without_optimizer_state_refuses(tmp_path):
    m, opt = _small()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, m)
    assert mgr.restore(m)[0] == 1
    with pytest.raises(ValueError, match="no optimizer state"):
        mgr.restore(m, opt)


def test_step_after_restore_equals_step_on_saved(tmp_path):
    """Train one step, save, restore into fresh objects; the next step
    (same batch, same generator seed) on both gives bit-identical
    parameters, at the lr of schedule(1)."""
    cfg = _tiny_cfg()
    sched = lr_schedule(0.01, 1, 1, 0.1)     # 0.01 at step 0, 0.001 at 1
    model = init_weights(AITDetector(cfg), 0)
    opt = make_optimizer(cfg, model)
    step = make_train_step(model, opt, sched, device="cpu")
    step(_batch(0), torch.Generator().manual_seed(0))
    assert step.step == 1
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(step.step, model, opt)

    model2 = AITDetector(cfg)                # zeros until restored
    opt2 = make_optimizer(cfg, model2)
    start, _ = mgr.restore(model2, opt2)
    step2 = make_train_step(model2, opt2, sched, device="cpu",
                            start_step=start)
    assert step2.step == 1
    m1 = step(_batch(1), torch.Generator().manual_seed(1))
    m2 = step2(_batch(1), torch.Generator().manual_seed(1))
    assert step.step == step2.step == 2
    for g in opt2.param_groups:
        assert g["lr"] == pytest.approx(sched(1) * g["lr_mult"])
    assert sched(1) != sched(0)
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    _same_state(model.state_dict(), model2.state_dict())
    _same_state(opt.state_dict(), opt2.state_dict())


def test_start_step_sets_the_schedules_lr(monkeypatch):
    """The lr of a step from start_step 5 is schedule(5) (the forward is
    stubbed: gradients stay empty, the update is weight decay alone)."""
    from ait_tpu_torch.train import state

    monkeypatch.setattr(state, "grads_and_metrics",
                        lambda *a, **k: {"loss": torch.zeros(())})
    cfg = _tiny_cfg()
    sched = lr_schedule(0.02, 2, 1, 0.5, warmup_steps=1)
    model = AITDetector(cfg)
    opt = make_optimizer(cfg, model)
    step = make_train_step(model, opt, sched, device="cpu", start_step=5)
    assert step.step == 5
    step(_batch(2), torch.Generator().manual_seed(2))
    assert step.step == 6
    assert sched(5) not in (sched(0), sched(1))
    for g in opt.param_groups:
        assert g["lr"] == pytest.approx(sched(5) * g["lr_mult"])


def _config_pairs():
    yml = os.path.join(REPO, "cfgs", "res101_ls.yml")
    over = ["TRAIN.BATCH_SIZE", "64", "tpu.wide_buckets", "((608, 1216),)",
            "model.sk_gate", "fixed", "ANCHOR_SCALES", "(4, 8, 16, 32)"]
    return {"default": (JaxConfig(), Config()),
            "res101_ls": (JaxConfig.from_yaml(yml), Config.from_yaml(yml)),
            "overrides": (JaxConfig().override(over),
                          Config().override(over))}


@pytest.mark.parametrize("name", ["default", "res101_ls", "overrides"])
def test_save_config_and_reload_match_jax(tmp_path, name):
    jcfg, cfg = _config_pairs()[name]
    jax_save_config(str(tmp_path / "jax"), jcfg)
    save_config(str(tmp_path / "port"), cfg)
    want = (tmp_path / "jax" / "config.json").read_bytes()
    assert (tmp_path / "port" / "config.json").read_bytes() == want
    doc = json.loads(want)
    assert dataclasses.asdict(_config_from_json(doc)) == \
        dataclasses.asdict(jax_config_from_json(doc))
