"""The plain reference against the port's own plain path on the CPU, both in
float32 on the same seeded weights, at a tiny canvas with the published
widths and depth: the eval forward stage by stage, and three training
steps (losses, first gradients, updates).  These tests may import both;
the reference itself imports neither the port nor the harness."""

import numpy as np
import pytest
import torch

from benchlib import judge, probes, spec, traffic
from benchlib import train as btrain
from benchlib.weights import init_of, make_weights
from portbench_cells import tiny_cell
from reference import model as R
from reference.params import frozen, param_shapes


def test_param_shapes_are_the_programs():
    from ait_tpu_torch.models import AITDetector

    for cfg_name in ("ait_res50_voc", "ait_res101_ls"):
        import json
        import os

        from conftest import BENCH
        with open(os.path.join(BENCH, "configs", cfg_name + ".json")) as f:
            cfg = json.load(f)["config"]
        sd = AITDetector(spec.program_config(cfg)).state_dict()
        shapes = param_shapes(cfg)
        assert set(sd) == set(shapes)
        for k, v in sd.items():
            assert tuple(v.shape) == shapes[k], k


def test_weights_follow_the_programs_initializers():
    """Each leaf's kind and scale against what the program's init_params
    draws for it (zeros and ones exactly; the spread of large leaves)."""
    from ait_tpu_torch.models import AITDetector
    from ait_tpu_torch.train import init_params

    cell = tiny_cell()
    pc = spec.program_config(cell.cfg)
    model = init_params(AITDetector(pc), pc, 3)
    sd = model.state_dict()
    ours = make_weights(param_shapes(cell.cfg), 3, "cpu")
    for k, v in sd.items():
        kind, scale = init_of(k, tuple(v.shape))
        if kind in ("zeros", "ones"):
            assert torch.equal(v, ours[k]), k
        elif v.numel() >= 4096:
            assert abs(float(v.std()) / float(ours[k].std()) - 1) < 0.05, k
            assert abs(float(v.abs().max()) - float(ours[k].abs().max())) \
                <= 0.25 * float(v.abs().max()), k


def _eval(cell, seed):
    from ait_tpu_torch.predict import OneShotPredictor

    cfg = cell.cfg
    W = make_weights(param_shapes(cfg), seed, "cpu")
    pred = OneShotPredictor(spec.program_config(cfg), W, device="cpu",
                            dtype=torch.float32)
    b = traffic.make_batches(cell.traffic, seed)[0]
    pr, cap = probes.Probes(), probes.Capture()
    cap.install(pr)
    cap.on = True
    dets = pred.predict_prepared(b["image"], b["query"], b["im_info"])
    pr.undo()
    return W, b, cap.records[0], dets


def test_eval_forward_matches_the_ports_plain_path():
    cell = tiny_cell()
    W, b, rec, dets = _eval(cell, 11)
    cfg = cell.cfg
    with torch.no_grad():
        feats, rois, h, rd, rv = R.detect(
            W, cfg, torch.as_tensor(b["image"]), torch.as_tensor(b["query"]),
            torch.as_tensor(b["im_info"]))
    assert judge._rel_gap(rec["rpn_cls"], feats.rpn.cls_logits) < 1e-4
    assert judge._rel_gap(rec["rpn_deltas"], feats.rpn.deltas) < 1e-4
    assert float((rois - rec["rois"]).abs().max()) < 1e-3
    assert judge._rel_gap(rec["bbox_pred"], h.deltas) < 1e-4
    got = judge.judge_serve(W, cfg, {**rec, **b, "dets": dets})
    assert got["roi_miss"] == 0 and got["det_miss"] == 0
    assert got["score_gap"] < 1e-4 and got["box_gap"] < 1e-4
    for i, d in enumerate(dets):
        assert np.allclose(d, rd[i][rv[i]].numpy(), atol=1e-3)


def test_train_steps_match_the_ports_plain_path():
    from ait_tpu_torch.models import AITDetector
    from ait_tpu_torch.train import make_train_step
    from ait_tpu_torch.train.optim import make_optimizer

    cell = tiny_cell("train")
    cfg = cell.cfg
    pc = spec.program_config(cfg)
    seed = 7
    model = AITDetector(pc, dtype=torch.float32)
    model.load_state_dict(make_weights(param_shapes(cfg), seed, "cpu"))
    opt = make_optimizer(pc, model)
    step = make_train_step(model, opt, btrain.schedule_of(cell),
                           device="cpu")
    pool = btrain._bucket_first(traffic.make_batches(cell.traffic, seed,
                                                     train=True))[:3]
    gen = torch.Generator().manual_seed(btrain.generator_seed(seed))
    pr, cap = probes.Probes(), probes.Capture()
    cap.install(pr)
    cap.on = True
    named = dict(model.named_parameters())
    losses = []
    for k in range(3):
        losses.append(float(step(pool[k], gen)["loss"]))
        if k == 0:
            buf1 = {n: opt.state[p]["momentum_buffer"].clone()
                    for n, p in named.items() if p in opt.state}
    pr.undo()
    params = {n: p.detach().clone() for n, p in named.items()
              if not frozen(n)}
    got = judge.judge_train(cell, seed, pool, cap.records, losses, buf1,
                            params, btrain.generator_seed(seed), "cpu")
    assert got["loss_gap"] < 1e-5
    assert got["grad_gap"] < 1e-3 and got["update_gap"] < 1e-2
    assert got["rpn_gap"] < 1e-4 and got["roi_miss"] == 0


def test_reference_lrs_follow_the_configuration():
    """The reference's step decay, worked out from the configuration alone,
    meets the program's lr_schedule across two decays."""
    from ait_tpu_torch.train.optim import lr_schedule
    from reference import train as T

    tr = {"lr": 0.01, "gamma": 0.1, "lr_decay_step_epochs": 2,
          "steps_per_epoch": 3}
    sched = lr_schedule(tr["lr"], tr["steps_per_epoch"],
                        tr["lr_decay_step_epochs"], tr["gamma"])
    want = [sched(k) for k in range(14)]
    assert T.lrs(tr, 14) == pytest.approx(want)
    assert want[5] == pytest.approx(0.01) and want[6] == pytest.approx(1e-3)
