"""The harness on the CPU: traffic from the seed, the operation and byte
counts against hand counts, each per-layer reader on a synthetic trace,
and a cell, configuration, mix and metric added as new files alone."""

import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

from benchlib import counts, serve, spec, traffic
from benchlib.tracefile import Trace
from conftest import BENCH, ROOT
from portbench_cells import tiny_cell
from reference import model as R
from reference.params import param_shapes


# ---------------------------------------------------------------- traffic


def _mix():
    with open(os.path.join(BENCH, "traffic", "serve_b8.json")) as f:
        mix = json.load(f)
    mix.update(tiny_cell().traffic)
    return mix


def test_traffic_is_a_function_of_the_seed():
    mix = _mix()
    big = 2 ** 31 + 12345
    a, b = traffic.make_batches(mix, big), traffic.make_batches(mix, big)
    for x, y in zip(a, b):
        for k in x:
            assert np.array_equal(x[k], y[k])
    c = traffic.make_batches(mix, big + 1)
    assert any(not np.array_equal(x["image"], y["image"])
               for x, y in zip(a, c))


def test_every_seed_gets_the_same_sizes_in_another_order():
    mix = _mix()

    def sizes(seed):
        pool = traffic.make_batches(mix, seed)
        return sorted((b["image"].shape, tuple(map(tuple, b["im_info"])))
                      for b in pool), [b["image"].shape for b in pool]

    (s1, o1), (s2, o2) = sizes(1), sizes(2)
    assert sorted(x[0] for x in s1) == sorted(x[0] for x in s2)
    infos1 = sorted(i for _, info in s1 for i in info)
    infos2 = sorted(i for _, info in s2 for i in info)
    assert infos1 == infos2


def test_space_to_depth_layout():
    x = np.arange(2 * 4 * 6 * 3).reshape(2, 4, 6, 3)
    y = traffic.space_to_depth(x)
    for dy in range(2):
        for dx in range(2):
            for c in range(3):
                assert np.array_equal(y[:, :, :, dy * 6 + dx * 3 + c],
                                      x[:, dy::2, dx::2, c])
    back = R.to_rgb_image(torch.as_tensor(y))
    want = R.to_rgb_image(torch.as_tensor(x))
    assert torch.allclose(back, want)


def test_serve_sample_holds_every_bucket():
    mix = _mix()
    pool = traffic.make_batches(mix, 5)
    canvases = [b["image"].shape for b in pool]
    idx = serve._sample(mix, 5, canvases)
    assert {canvases[i % len(canvases)] for i in idx} == set(canvases)
    assert idx == serve._sample(mix, 5, canvases)


def test_train_mix_boxes_lie_inside_the_content():
    cell = tiny_cell("train")
    for b in traffic.make_batches(cell.traffic, 3, train=True):
        for j in range(b["gt_boxes"].shape[0]):
            n = b["num_boxes"][j]
            g = b["gt_boxes"][j, :n]
            h, w = b["im_info"][j, :2]
            assert (g[:, 2] <= w - 1).all() and (g[:, 3] <= h - 1).all()
            assert (g[:, :2] >= 0).all() and (g[:, 4] == 1).all()
            assert not b["gt_boxes"][j, n:].any()


# ---------------------------------------------------------------- counts


def test_ffn_and_attention_bounds_by_hand():
    n, d, h = 1000, 512, 2048
    fwd_bytes = n * d * 2 * 2 + 2 * d * h * 2 + (h + 3 * d) * 4
    assert counts.ffn_bound_s("fwd", n) == max(
        fwd_bytes / 3.35e12, 4 * n * d * h / 989e12)
    p, tq, tk = 10, 64, 56
    proj = p * (2 * tq * d * d + 4 * tk * d * d)
    flops = proj + p * (4 * tq * tk * d + 2 * 64 * 8 * 64 + 2 * tq * 64 * d)
    nbytes = (p * (tq + tk) * d * 2 + (3 * d * d + 64 * 8 * 64 + 8 * 64 +
                                       64 * d) * 2 + 2 * d * 4 + tq * tk +
              p * tq * d * 2)
    assert counts.attn_bound_s("eval", p, tq, tk, False) == max(
        nbytes / 3.35e12, flops / 989e12)


def test_flop_counter_counts_products_by_hand():
    cfg = tiny_cell().cfg
    dev = torch.device("meta")
    W = {k: torch.empty(s, device=dev)
         for k, s in param_shapes(cfg).items()}
    hw = 5 * 7
    feat = torch.empty(2, 1024, 5, 7, device=dev)
    got = counts._count(lambda: R.rpn_head(W, feat, R.F32))
    assert got == 2 * 2 * hw * (9 * 1024 * 512 + 512 * 18 + 512 * 36)
    x = torch.empty(3, 11, 512, device=dev)
    got = counts._count(lambda: R.ffn(W, "transformer.enc_layer0.pos_ffn",
                                      x, R.F32))
    assert got == 2 * 2 * 33 * 512 * 2048


def test_model_flops_grows_with_the_canvas_and_the_rois():
    cfg = tiny_cell().cfg
    a = counts.model_flops(cfg, (64, 96), 2, 10, False)
    b = counts.model_flops(cfg, (128, 96), 2, 10, False)
    c = counts.model_flops(cfg, (64, 96), 2, 20, False)
    t = counts.model_flops(cfg, (64, 96), 2, 10, True)
    assert a < b and a < c and 2 * a < t < 4 * a


# ---------------------------------------------------------------- readers


def _trace():
    """Two steps of 1000 us; a backbone range holding two kernels, an
    attention range (3 pairs of 64 x 56 tokens, cross) holding one, and an
    FFN range (168 rows) holding one, launched on thread 1."""
    ev = []

    def x(cat, name, ts, dur, tid=1, **args):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts,
                   "dur": dur, "tid": tid, "pid": 1, "args": args})

    x("user_annotation", "ProfilerStep#0", 0, 1000)
    x("user_annotation", "ProfilerStep#1", 1000, 1000)
    x("user_annotation", "pb:backbone", 10, 100)
    x("cuda_runtime", "cudaLaunchKernel", 20, 5, correlation=1)
    x("cuda_runtime", "cudaLaunchKernel", 50, 5, correlation=2)
    x("kernel", "conv_a", 100, 200, tid=7, correlation=1)
    x("kernel", "conv_b", 300, 100, tid=7, correlation=2)
    x("user_annotation", "pb:attn.eval|3,64,56,0", 1100, 50)
    x("cuda_runtime", "cudaLaunchKernel", 1110, 5, correlation=3)
    x("kernel", "attn", 1200, 40, tid=7, correlation=3)
    x("user_annotation", "pb:ffn.fwd|168", 1300, 50)
    x("cuda_runtime", "cudaLaunchKernel", 1310, 5, correlation=4)
    x("kernel", "ffn", 1400, 60, tid=7, correlation=4)
    x("user_annotation", "pb:roi_align", 1500, 50)
    x("cpu_op", "aten::item", 1600, 300)
    return Trace(ev)


class _Ctx:
    def __init__(self, kind, trace):
        self.kind, self.trace, self.steps = kind, trace, 2
        self.flops_per_step = 1e12
        self.busy_s, self.window_s, self.plain_window_s = 0.5, 2.0, 1.6


@pytest.mark.parametrize("name,want", [
    ("backbone_ms.serve", 0.15),
    ("roi_align_ms.serve", None),
    ("mfu.serve", 100.0 * 1e12 * 2 / 1.6 / 989e12),
    ("device_idle_share.serve", 100.0 * (1.0 - 0.5 / 1.6)),
    ("device_busy_ms.serve", 250.0),
    ("attn_roofline.serve",
     100.0 * counts.attn_bound_s("eval", 3, 64, 56, False) / 40e-6),
    ("ffn_roofline.serve", 100.0 * counts.ffn_bound_s("fwd", 168) / 60e-6),
])
def test_serve_readers_on_a_synthetic_trace(name, want):
    got = spec.reader(name)(_Ctx("serve", _trace()))
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want, rel=1e-9)
    assert spec.reader(name)(_Ctx("train", _trace())) is None


@pytest.mark.parametrize("name", ["mfu.train", "attn_roofline.train",
                                  "ffn_roofline.train",
                                  "device_idle_share.train",
                                  "device_busy_ms.train"])
def test_train_readers_on_a_synthetic_trace(name):
    assert spec.reader(name)(_Ctx("serve", _trace())) is None
    got = spec.reader(name)(_Ctx("train", _trace()))
    if name.startswith("attn"):
        assert got is None          # no train forward or backward ran
    elif name == "ffn_roofline.train":
        assert got == pytest.approx(
            100.0 * counts.ffn_bound_s("fwd", 168) / 60e-6)
    else:
        assert got > 0


def test_trace_window_busy_and_gaps():
    tr = _trace()
    assert tr.window_s == pytest.approx(2000e-6)
    assert tr.busy_s == pytest.approx(400e-6)
    ops = dict(tr.top_device_ops())
    assert ops["conv_a"] == pytest.approx(200e-6)
    gaps = dict(tr.idle_gaps())
    assert sum(gaps.values()) == pytest.approx(1600e-6)
    assert gaps["- aten::item"] == pytest.approx(540e-6)
    assert gaps["pb:backbone -"] == pytest.approx(100e-6)


# ---------------------------------------------------------------- data


def test_a_cell_added_as_files_alone_runs(tmp_path):
    """A configuration, a mix, a limits file and a metric reader added as
    new files, and a cell and a metric added as entries, are picked up by
    name and run on the CPU, the new metric read from the trace."""
    root = str(tmp_path)
    shutil.copytree(BENCH, os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    tiny = tiny_cell()
    conf = dict(tiny.config, name="ait_added")
    conf["config"]["tpu"]["compute_dtype"] = "float32"
    pb = os.path.join(root, "portbench")
    with open(os.path.join(pb, "configs", "ait_added.json"), "w") as f:
        json.dump(conf, f)
    with open(os.path.join(pb, "traffic", "serve_added.json"), "w") as f:
        json.dump(tiny.traffic, f)
    with open(os.path.join(pb, "checks", "added_b2.json"), "w") as f:
        json.dump({"rpn_gap": 0.01, "roi_miss": 0, "score_gap": 0.01,
                   "box_gap": 0.01, "det_miss": 0}, f)
    with open(os.path.join(pb, "metrics", "steps_seen.serve.py"), "w") as f:
        f.write("def read(ctx):\n    return float(ctx.steps)\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "ait_added", "source": "x",
                             "file": "portbench/configs/ait_added.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "added_b2", "config": "ait_added",
                               "traffic": "serve_added", "chips": 1,
                               "why": "x"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "serve" in m["name"]:
            m["workloads"].append("added_b2")
    bench["per_layer"].append({"name": "steps_seen.serve", "unit": "1",
                               "better": "higher", "source": "device_trace",
                               "layer": "device",
                               "moves": "serve_pairs_per_s",
                               "workloads": ["added_b2"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    cell = spec.load_cell("added_b2", root=root)
    assert cell.cfg["tpu"]["image_size"] == [64, 96]
    assert [m["name"] for m in cell.per_layer] == ["steps_seen.serve"]
    assert {m["name"] for m in cell.end_to_end} == {
        "serve_pairs_per_s", "serve_batch_ms_p95", "setup_s"}
    import run as RUN

    out = serve.run(cell, 9, 0.5, True, time.monotonic(), device="cpu")
    RUN.per_layer(cell, out)
    assert out["metrics"]["steps_seen.serve"]["value"] == 2.0
    checks, ok = RUN.checks(cell, out["judged"])
    assert ok, checks
