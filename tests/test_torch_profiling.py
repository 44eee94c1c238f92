"""The port's recorder (ait_tpu_torch/utils/profiling.py): spans and counts
while `recording()` is open, nothing outside it, one clock with
torch.profiler's traces, and the span tree the predictor and the train step
record a batch or step.  Imports no JAX: the `gpu` tests run on the card
with `python -m pytest --noconftest -m gpu tests/test_torch_profiling.py`.
"""

import json
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from ait_tpu_torch.utils import profiling
from ait_tpu_torch.utils.profiling import (SYNC_WARNING, annotate, count,
                                           device_trace, recording)
from torch_parallel_workers import tiny_batch, tiny_cfg, tiny_model, trainer

PREDICT_TREE = [
    ("ait:predict", None), ("ait:h2d", "ait:predict"),
    ("ait:forward", "ait:predict"),
    ("ait:backbone.image", "ait:forward"),
    ("ait:backbone.query", "ait:forward"),
    ("ait:coattention", "ait:forward"), ("ait:rpn", "ait:forward"),
    ("ait:proposals", "ait:forward"), ("ait:roi_align", "ait:forward"),
    ("ait:transformer", "ait:forward"), ("ait:sknet", "ait:forward"),
    ("ait:top", "ait:forward"), ("ait:heads", "ait:forward"),
    ("ait:postprocess", "ait:predict"), ("ait:d2h", "ait:predict")]
TRAIN_TREE = [
    ("ait:train_step", None), ("ait:h2d", "ait:train_step"),
    ("ait:forward", "ait:train_step"),
    ("ait:backbone.image", "ait:forward"),
    ("ait:backbone.query", "ait:forward"),
    ("ait:coattention", "ait:forward"), ("ait:rpn", "ait:forward"),
    ("ait:proposals", "ait:forward"), ("ait:targets", "ait:forward"),
    ("ait:losses", "ait:forward"), ("ait:targets", "ait:forward"),
    ("ait:roi_align", "ait:forward"), ("ait:transformer", "ait:forward"),
    ("ait:sknet", "ait:forward"), ("ait:top", "ait:forward"),
    ("ait:heads", "ait:forward"), ("ait:losses", "ait:forward"),
    ("ait:backward", "ait:train_step"), ("ait:optimizer", "ait:train_step")]


def _tree(rec, root):
    """(name, parent's name) of the spans under root, in the order
    opened."""
    i = rec.spans.index(root)
    return [(s.name, rec.spans[s.parent].name if s.parent >= 0 else None)
            for s in rec.spans if s.root == i]


def test_span_fields_parent_and_root_id():
    with recording() as rec:
        t0 = time.time_ns()
        with annotate("root", id=7) as r:
            with annotate("child") as c:
                with annotate("leaf"):
                    pass
            with annotate("sibling"):
                pass
        t1 = time.time_ns()
    assert [s.name for s in rec.spans] == ["root", "child", "leaf", "sibling"]
    assert r is rec.spans[0] and c is rec.spans[1]
    assert [s.parent for s in rec.spans] == [-1, 0, 1, 0]
    assert [s.root for s in rec.spans] == [0, 0, 0, 0]
    assert [s.id for s in rec.spans] == [7, 7, 7, 7]
    assert {s.thread for s in rec.spans} == {threading.get_ident()}
    for s in rec.spans:
        assert t0 <= s.start_ns <= s.end_ns <= t1
    leaf, sib = rec.spans[2], rec.spans[3]
    assert c.start_ns <= leaf.start_ns <= leaf.end_ns <= c.end_ns
    assert c.end_ns <= sib.start_ns and sib.end_ns <= r.end_ns
    assert rec.roots() == [r]


def test_roots_nesting_and_per_thread_stacks():
    barrier = threading.Barrier(2, timeout=30)
    with recording() as rec:
        def worker():
            with annotate("thread_root", id=2):
                barrier.wait()          # both roots open at once
                with annotate("thread_child"):
                    barrier.wait()

        th = threading.Thread(target=worker)
        th.start()
        with annotate("main_root", id=1):
            barrier.wait()
            with annotate("main_child"):
                barrier.wait()
        th.join(timeout=30)
        assert not th.is_alive()
        with annotate("second", id=3):
            pass
    by = {s.name: (i, s) for i, s in enumerate(rec.spans)}
    for child, root in (("thread_child", "thread_root"),
                        ("main_child", "main_root")):
        _, c = by[child]
        ri, r = by[root]
        assert c.parent == ri and c.root == ri and c.id == r.id
        assert c.thread == r.thread
    assert by["thread_root"][1].thread != by["main_root"][1].thread
    assert by["second"][1].parent == -1 and by["second"][1].id == 3
    assert sorted(s.id for s in rec.roots()) == [1, 2, 3]


def test_off_path_records_nothing_and_shares_one_context(monkeypatch):
    def no_torch(*a, **k):
        raise AssertionError("a torch call with the recorder off")

    monkeypatch.setattr(torch.profiler, "record_function", no_torch)
    monkeypatch.setattr(torch.cuda, "is_available", no_torch)
    a, b = annotate("ait:x", id=1), annotate("ait:y")
    assert a is b
    with a:
        count("host_syncs")
        with annotate("ait:z"):
            pass
    assert profiling._record is None and not profiling.is_recording()
    monkeypatch.undo()
    with recording() as rec:
        assert profiling.is_recording()
    assert rec.spans == [] and rec.counts == {}
    assert annotate("ait:x") is a


def test_counts_go_to_the_innermost_span():
    with recording() as rec:
        count("outside", 2)
        with annotate("outer", id=0):
            count("host_syncs")
            with annotate("inner"):
                count("host_syncs")
                count("host_syncs", 3)
            count("other")
    outer, inner = rec.spans
    assert outer.counts == {"host_syncs": 1, "other": 1}
    assert inner.counts == {"host_syncs": 4}
    assert rec.counts == {"outside": 2}


def test_a_recording_is_not_nested_and_closes_on_error():
    with pytest.raises(RuntimeError):
        with recording():
            with recording():
                pass
    assert profiling._record is None
    with pytest.raises(ValueError):
        with recording() as rec:
            with annotate("raises", id=0):
                raise ValueError
    assert profiling._record is None
    assert rec.spans[0].end_ns >= rec.spans[0].start_ns > 0


def test_a_span_holds_its_ops_on_the_profilers_clock(tmp_path):
    """The spans and the events of a profiler trace exported in the same
    block lie on one clock: each matmul's event lies inside its span."""
    from torch.profiler import ProfilerActivity, profile

    a = torch.ones(256, 256)
    path = str(tmp_path / "t.json")
    with recording() as rec:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for i in range(4):
                with annotate("ait:mm", id=i):
                    a.matmul(a)
        prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base = int(doc["baseTimeNanoseconds"])
    ops = sorted((e for e in doc["traceEvents"]
                  if e.get("name") == "aten::matmul"), key=lambda e: e["ts"])
    assert len(ops) == 4 == len(rec.spans)
    for s, e in zip(rec.spans, ops):
        start = base + e["ts"] * 1e3
        assert s.start_ns <= start <= start + e["dur"] * 1e3 <= s.end_ns


def test_device_trace_holds_the_spans(tmp_path):
    with device_trace(str(tmp_path)):
        with annotate("ait:outer", id=5):
            with annotate("ait:inner"):
                torch.ones(32, 32).sum()
    with open(tmp_path / "trace.json") as f:
        doc = json.load(f)
    spans = [e for e in doc["traceEvents"] if e.get("cat") == "ait_span"]
    assert [e["name"] for e in spans] == ["ait:outer", "ait:inner"]
    assert [e["args"]["parent"] for e in spans] == [-1, 0]
    assert [e["args"]["id"] for e in spans] == [5, 5]
    outer, inner = spans
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3
    ops = [e for e in doc["traceEvents"] if e.get("name") == "aten::sum"]
    assert ops and inner["ts"] <= ops[0]["ts"]
    assert profiling._record is None


@pytest.fixture(scope="module")
def tiny_predictor():
    from ait_tpu_torch.predict import OneShotPredictor

    torch.manual_seed(0)
    cfg = tiny_cfg()
    return OneShotPredictor(cfg, tiny_model(cfg).state_dict(), device="cpu",
                            dtype=torch.float32)


def test_the_predictor_records_its_tree_once_a_batch(tiny_predictor):
    b = tiny_batch()
    args = (b["image"].numpy(), b["query"].numpy(), b["im_info"].numpy())
    first = tiny_predictor.batches
    want = tiny_predictor.predict_prepared(*args)
    with recording() as rec:
        got = [tiny_predictor.predict_prepared(*args) for _ in range(2)]
    roots = rec.roots()
    assert [r.name for r in roots] == ["ait:predict"] * 2
    assert [r.id for r in roots] == [first + 1, first + 2]
    for r in roots:
        assert _tree(rec, r) == PREDICT_TREE
        assert {s.id for s in rec.spans if s.root == rec.spans.index(r)} \
            == {r.id}
    for dets in got:          # the recorder changes nothing it records
        for x, y in zip(dets, want):
            assert np.array_equal(x, y)
    assert rec.counts == {}   # no CUDA device: no sync counted


def test_the_train_step_records_its_tree_once_a_step():
    torch.manual_seed(0)
    cfg = tiny_cfg()
    step = trainer(tiny_model(cfg), cfg)
    gen = torch.Generator().manual_seed(3)
    step(tiny_batch(), gen)
    with recording() as rec:
        for _ in range(2):
            m = step(tiny_batch(), gen)
    assert torch.isfinite(m["loss"])
    roots = rec.roots()
    assert [r.name for r in roots] == ["ait:train_step"] * 2
    assert [r.id for r in roots] == [1, 2]
    for r in roots:
        assert _tree(rec, r) == TRAIN_TREE


# ---------------------------------------------------------------- the card


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.gpu
def test_item_counts_one_host_sync_where_it_waits(gpu):
    x = torch.ones(1024, device=gpu)
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    with recording() as rec:
        with annotate("outer", id=0):
            y = (x * 2).sum()
            with annotate("reads"):
                y.item()
            torch.cuda.synchronize()    # not a reported sync
    outer, reads = rec.spans
    assert reads.counts == {"host_syncs": 1}
    assert outer.counts == {} and rec.counts == {}
    assert torch.cuda.get_sync_debug_mode() == prev
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        (x * 2).sum().item()           # the mode is back: no warning
    assert not any(SYNC_WARNING in str(w.message) for w in seen)


@pytest.mark.gpu
def test_a_span_holds_its_kernels_device_interval(gpu, tmp_path):
    """A span opened before a `torch.cuda._sleep` launch and closed after
    a synchronize holds the kernel's interval in a CUDA-only trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    path = str(tmp_path / "t.json")
    with recording() as rec:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with annotate("ait:sleep", id=0):
                torch.cuda._sleep(2_000_000)
                torch.cuda.synchronize()
        prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base = int(doc["baseTimeNanoseconds"])
    kernels = [e for e in doc["traceEvents"] if e.get("cat") == "kernel"]
    assert kernels
    (s,) = rec.spans
    for k in kernels:
        start = base + k["ts"] * 1e3
        assert s.start_ns <= start <= start + k["dur"] * 1e3 <= s.end_ns
    assert max(k["dur"] for k in kernels) > 100.0     # the sleep ran, in us


@pytest.mark.gpu
def test_a_backbone_pass_makes_no_host_sync(gpu):
    """After the first pass the backbone's constants are on the card (the
    input's mean and std, every pair's folded kernel and bias): a pass on a
    uint8 image in 12 planes and a query in 3 synchronizes nothing."""
    from ait_tpu_torch.models.detector import _to_model_input
    from ait_tpu_torch.models.resnet import ResNetBackbone

    torch.manual_seed(0)
    bb = ResNetBackbone(dtype=torch.bfloat16)
    with torch.no_grad():
        for p in bb.parameters():
            p.normal_(0, 0.05)
    bb.to(gpu)
    image = torch.randint(0, 256, (2, 64, 80, 12), dtype=torch.uint8,
                          device=gpu)
    query = torch.randint(0, 256, (2, 128, 128, 3), dtype=torch.uint8,
                          device=gpu)

    def passes():
        return [bb(_to_model_input(x, torch.bfloat16)) for x in (image, query)]

    with torch.inference_mode():
        passes()
        torch.cuda.synchronize()
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            feats = passes()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    assert [tuple(f.shape) for f in feats] == [(2, 8, 10, 1024),
                                                (2, 8, 8, 1024)]
    assert all(bool(torch.isfinite(f.float()).all()) for f in feats)
