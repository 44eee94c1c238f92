"""The port's train and eval CLIs (ait_tpu_torch/tools) on the CPU.

* `build_config` against the JAX CLI's over a grid of flags.  JAX's
  tools/trainval_net.py runs in a subprocess: importing it sets
  process-wide JAX options (the rbg PRNG, a compile cache) that would leak
  into other tests of the same worker.
* On the synthetic devkit of tests/fixtures.py at tiny sizes (`--set`, as
  tests/test_cli_eval.py, and `--device cpu`): the train CLI for 2 steps,
  then `--r true` from its checkpoint; the eval CLI with `--a 2` per pass
  and with `--fuse_shots` (the same detections on every pair, up to the
  rounding of the image backbone at another batch), with
  `--write_results` and from `--with_cache_file`; `from_run` against a
  predictor built from the restored state; the refusals of what the port
  does not run yet (the parallel families, the overlays); every recipe,
  `--dataset coco` and `--net vgg16`, through both CLIs.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fixtures import make_coco_devkit, make_voc_devkit
from ait_tpu_torch.data import OneShotLoader
from ait_tpu_torch.data.coco import read_data_pickle
from ait_tpu_torch.data.voc import filter_seen, load_voc
from ait_tpu_torch.models import AITDetector
from ait_tpu_torch.predict import OneShotPredictor
from ait_tpu_torch.tools import test_net, trainval_net
from ait_tpu_torch.train import init_weights
from ait_tpu_torch.train.checkpoint import CheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on the CPU's
    cores, and each torch process would otherwise start one a core."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)

GRID = [(net, ds, ls, g, st)
        for net in ("res50", "res101", "vgg16")
        for ds in ("pascal_voc", "coco")
        for ls in (False, True)
        for g in (0, 1)
        for st in ((), ("TRAIN.BATCH_SIZE", "64", "model.sk_gate", "fixed"))]


def _flags(case):
    net, ds, ls, g, st = case
    argv = ["--net", net, "--dataset", ds, "--g", str(g)]
    if ls:
        argv.append("--ls")
    if st:
        argv += ["--set", *st]
    return argv


_JAX_SIDE = """
import dataclasses, json, sys
sys.path.insert(0, sys.argv[1])
import trainval_net
out = {}
for i, argv in enumerate(json.loads(sys.argv[2])):
    cfg = trainval_net.build_config(trainval_net.parse_args(argv))
    out[i] = dataclasses.asdict(cfg)
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_configs():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_SIDE, os.path.join(REPO, "tools"),
         json.dumps([_flags(c) for c in GRID])],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300,
        check=True)
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    return {int(k): v for k, v in json.loads(line[7:]).items()}


@pytest.mark.parametrize("i", range(len(GRID)),
                         ids=lambda i: "-".join(map(str, GRID[i][:4])) +
                         ("-set" if GRID[i][4] else ""))
def test_build_config_matches_jax(jax_configs, i):
    cfg = trainval_net.build_config(trainval_net.parse_args(_flags(GRID[i])))
    # through JSON on both sides: tuples and lists compare alike
    assert json.loads(json.dumps(dataclasses.asdict(cfg))) == jax_configs[i]


TINY = ["--set", "tpu.image_size", "(128, 160)", "tpu.portrait_bucket",
        "False", "tpu.compute_dtype", "float32",
        "TRAIN.SCALES", "(100,)", "TEST.SCALES", "(100,)",
        "TRAIN.RPN_PRE_NMS_TOP_N", "256", "TRAIN.RPN_POST_NMS_TOP_N", "32",
        "TRAIN.RPN_BATCHSIZE", "32", "TRAIN.BATCH_SIZE", "16",
        "TEST.RPN_PRE_NMS_TOP_N", "256", "TEST.RPN_POST_NMS_TOP_N", "32",
        "MAX_NUM_GT_BOXES", "8"]


def _common(root):
    return ["--dataset", "pascal_voc", "--net", "res50", "--data_dir",
            str(root), "--nw", "0", "--save_dir", str(root / "models"),
            "--device", "cpu"]


def _train(root, *extra):
    return trainval_net.main(_common(root) + [
        "--seen", "1", "--bs", "3", "--disp_interval", "1",
        "--checkpoint_interval", "1", *extra] + TINY)


def _eval(root, out, *extra):
    return test_net.main(_common(root) + [
        "--a", "2", "--bs", "2", "--output_dir", str(root / out),
        *extra] + TINY)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    for split in ("trainval", "test"):
        make_voc_devkit(str(root / "VOCdevkit2007"), image_set=split)
    with pytest.MonkeyPatch.context() as mp:
        # MetricWriter writes its JSONL alone: importing TensorBoard here
        # pulls in TensorFlow, ~10 s
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        first = _train(root, "--epochs", "1")
        run_dir = first["run_dir"]
        with open(os.path.join(run_dir, "logs", "metrics.jsonl")) as f:
            rows_first = len(f.readlines())
        resumed = _train(root, "--epochs", "2", "--r", "true")
    per_pass = _eval(root, "out_pass", "--write_results")
    fused = _eval(root, "out_fused", "--fuse_shots")
    return dict(root=root, run_dir=run_dir, first=first, resumed=resumed,
                rows_first=rows_first, per_pass=per_pass, fused=fused)


def test_train_then_resume(runs):
    first, resumed = runs["first"], runs["resumed"]
    # 6 records (3 images and their flips) in batches of 3: 2 steps an epoch
    assert (first["start_epoch"], first["start_step"], first["step"]) == \
        (1, 0, 2)
    assert (resumed["start_epoch"], resumed["start_step"],
            resumed["step"]) == (2, 2, 4)
    run_dir = runs["run_dir"]
    assert CheckpointManager(os.path.join(run_dir, "ckpt")).all_steps() == \
        [2, 3, 4]
    with open(os.path.join(run_dir, "logs", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    # one loss row and one perf row per displayed step, 4 steps
    assert len(rows) == 2 * runs["rows_first"] == 8
    losses = [r for r in rows if "loss" in r]
    assert [r["step"] for r in losses] == [1, 2, 3, 4]
    assert all(np.isfinite(r[k]) for r in losses
               for k in trainval_net.LOSS_KEYS)
    with open(os.path.join(run_dir, "config.json")) as f:
        saved = json.load(f)
    assert saved["model"]["coattention"] == "mha"
    assert saved["tpu"]["image_size"] == [128, 160]


def test_per_pass_and_fused_detections_agree(runs):
    """The same pairs, the same number of detections for each, and every
    row within 1e-3 (relative and absolute) of the row at its place: the
    fused step runs the image backbone at a batch of 1 image, the per-pass
    one at 2, and the CPU's convolutions round those batches differently
    (~1e-7, amplified to 5e-4 px in the boxes; tests/test_cli_eval.py
    holds the JAX CLIs to a looser, tie-tolerant match)."""
    root = runs["root"]
    names = sorted(f for f in os.listdir(root / "out_pass")
                   if f.endswith(".pkl"))
    assert len(names) == 2
    n = 0
    for name in names:
        a = read_data_pickle(str(root / "out_pass" / name))
        b = read_data_pickle(str(root / "out_fused" / name))
        assert sorted(a) == sorted(b)
        for ci in a:
            assert sorted(a[ci]) == sorted(b[ci])
            for ri in a[ci]:
                assert a[ci][ri].shape == b[ci][ri].shape, (ci, ri)
                np.testing.assert_allclose(a[ci][ri], b[ci][ri], rtol=1e-3,
                                           atol=1e-3, err_msg=f"{ci} {ri}")
                n += len(a[ci][ri])
    assert n > 0
    for pp, fu in zip(runs["per_pass"], runs["fused"]):
        assert 0.0 <= pp["mAP"] <= 1.0
        assert abs(pp["mAP"] - fu["mAP"]) < 1e-6


def test_eval_writes_results_and_reads_its_cache(runs, monkeypatch):
    root = runs["root"]
    info = (root / "out_pass" / "experiment.info").read_text()
    assert info.startswith("Session-")
    main_dir = root / "VOCdevkit2007" / "results" / "VOC2007" / "Main"
    files = sorted(os.listdir(main_dir))
    assert files
    for line in open(main_dir / files[0]):
        assert len(line.split()) == 6
    monkeypatch.setattr(test_net, "run_pass", lambda *a, **k: 1 / 0)
    cached = _eval(root, "out_pass", "--with_cache_file")
    assert cached == runs["per_pass"]


def test_from_run_equals_restored_predictor(runs):
    run_dir = runs["run_dir"]
    got = OneShotPredictor.from_run(run_dir, device="cpu",
                                    dtype=torch.float32)
    cfg = got.cfg
    model = AITDetector(cfg)
    step, meta = CheckpointManager(os.path.join(run_dir, "ckpt")).restore(
        model)
    assert step == 4 and meta == {"epoch": 2, "session": 1}
    want = OneShotPredictor(cfg, model.state_dict(), device="cpu",
                            dtype=torch.float32)
    devkit = str(runs["root"] / "VOCdevkit2007")
    view = filter_seen(load_voc(devkit, "2007", "test"), 2)
    batch = next(iter(OneShotLoader(view, cfg, training=False)
                      .test_epoch(2, num_workers=0)))
    args = (batch["image"], batch["query"], batch["im_info"])
    for a, b in zip(got.predict_prepared(*args),
                    want.predict_prepared(*args)):
        np.testing.assert_array_equal(a, b)


def test_from_run_without_checkpoint_keeps_seeded_weights(runs, tmp_path,
                                                         capsys):
    with open(os.path.join(runs["run_dir"], "config.json")) as f:
        (tmp_path / "config.json").write_text(f.read())
    pred = OneShotPredictor.from_run(str(tmp_path), device="cpu",
                                     dtype=torch.float32)
    assert "WARNING: no checkpoint" in capsys.readouterr().out
    want = init_weights(AITDetector(pred.cfg), 0).state_dict()
    got = pred.model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("cli,argv,item", [
    ("train", ["--set", "tpu.tp_size", "2"], "A15"),
    ("train", ["--set", "tpu.sp_size", "2"], "A15"),
    ("eval", ["--set", "tpu.sp_size", "2"], "A15"),
    ("eval", ["--vis"], "A13b"),
])
def test_refusals_name_the_roadmap_item(tmp_path, cli, argv, item):
    mod = trainval_net if cli == "train" else test_net
    with pytest.raises(SystemExit, match=item):
        mod.main(["--device", "cpu", "--data_dir", str(tmp_path / "none"),
                  "--save_dir", str(tmp_path / "models"), *argv])
    assert not (tmp_path / "models").exists()


@pytest.fixture(scope="module")
def recipe_root(tmp_path_factory):
    """A VOC devkit (trainval, test) and a COCO tree (2017 val) from the
    fixtures' seeds."""
    root = tmp_path_factory.mktemp("cli_recipes")
    for split in ("trainval", "test"):
        make_voc_devkit(str(root / "VOCdevkit2007"), image_set=split)
    make_coco_devkit(str(root))
    return root


# VGG16 at 64x64 queries and 3x3 rois: fc6 flattens the 4x4 query grid
VGG_TINY = ["TRAIN.query_size", "64", "POOLING_SIZE", "3"]


@pytest.mark.parametrize("cli", ["train", "eval"])
@pytest.mark.parametrize("recipe", ["coco", "vgg16"])
def test_every_recipe_trains_and_evaluates(recipe_root, tmp_path, cli,
                                           recipe):
    """`--dataset coco` (the non-local co-attention, COCO's anchors and
    box cap) and `--net vgg16` (cfgs/vgg16.yml) run through both CLIs: a
    few train steps with finite losses in metrics.jsonl, or an eval pass
    to its AP line."""
    data = (["--dataset", "coco", "--coco_set", "2017_val", "--net", "res50"]
            if recipe == "coco" else
            ["--dataset", "pascal_voc", "--net", "vgg16"])
    argv = data + ["--data_dir", str(recipe_root), "--nw", "0",
                   "--save_dir", str(tmp_path / "models"), "--device", "cpu",
                   "--seen", "1", "--bs", "2"]
    tiny = TINY + (VGG_TINY if recipe == "vgg16" else [])
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        if cli == "train":
            out = trainval_net.main(argv + [
                "--epochs", "1", "--debug", "--disp_interval", "1",
                "--checkpoint_interval", "100"] + tiny)
        else:
            out = test_net.main(argv + [
                "--a", "1", "--debug", "--output_dir",
                str(tmp_path / "out")] + tiny)
    if cli == "train":
        assert out["step"] >= 1
        with open(os.path.join(out["run_dir"], "config.json")) as f:
            saved = json.load(f)
        assert saved["model"]["coattention"] == (
            "nonlocal" if recipe == "coco" else "mha")
        assert saved["model"]["backbone"] == (
            "vgg16" if recipe == "vgg16" else "resnet50")
        with open(os.path.join(out["run_dir"], "logs", "metrics.jsonl")) as f:
            rows = [json.loads(ln) for ln in f]
        losses = [r for r in rows if "loss" in r]
        assert losses and all(np.isfinite(r["loss"]) for r in losses)
    else:
        key = "AP50" if recipe == "coco" else "mAP"
        assert len(out) == 1 and 0.0 <= out[0][key] <= 1.0
