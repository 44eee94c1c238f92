"""The readers of the program's own record (benchlib/recorded.py and the
metrics of `recorded.METRICS`) on synthetic records, the idle attribution
by innermost span, and windows 4 and 5 after `_traced`'s three on a tiny
CPU cell."""

import json
import os
import time

import pytest

from ait_tpu_torch.utils.profiling import Record, Span
from benchlib import recorded, serve, spec, train
from conftest import ROOT
from portbench_cells import tiny_cell
import run_recorded


def _record(spans, counts=None):
    """A Record of (name, parent index or -1, start, end, id, counts)."""
    rec = Record()
    for name, parent, s, e, id_, c in spans:
        root = len(rec.spans) if parent < 0 else rec.spans[parent].root
        sp = Span(name, id_ if parent < 0 else rec.spans[root].id, parent,
                  root, 1, s)
        sp.end_ns = e
        sp.counts = dict(c or {})
        rec.spans.append(sp)
    rec.counts = dict(counts or {})
    return rec


def _serve_record():
    """Two batches of 10 and 6 us; the first's d2h 3 us, its backbone span
    2-4 us; syncs 2 + 1 in the first, 3 in the second, 1 outside."""
    return _record([
        ("ait:predict", -1, 1000, 11000, 0, None),
        ("ait:forward", 0, 1500, 7000, 0, None),
        ("ait:backbone.image", 1, 2000, 4000, 0, {"host_syncs": 2}),
        ("ait:d2h", 0, 8000, 11000, 0, {"host_syncs": 1}),
        ("ait:predict", -1, 12000, 18000, 1, None),
        ("ait:d2h", 4, 16000, 18000, 1, {"host_syncs": 3}),
    ], counts={"host_syncs": 1})


def test_idle_is_split_among_the_innermost_spans():
    rec = _record([
        ("root", -1, 1000, 11000, 0, None),
        ("a", 0, 2000, 5000, 0, None),
        ("b", 0, 6000, 10000, 0, None),
        ("c", 2, 7000, 8000, 0, None),
        ("root", -1, 12000, 13000, 1, None)])
    busy = [[1000, 2500], [4000, 6500], [7500, 9000], [500, 600],
            [12900, 14000]]
    idle = recorded.Idle(rec, busy)
    ns = {rec.spans[i].name + str(i): round(v * 1e9)
          for i, v in idle.by_span.items()}
    assert ns == {"a1": 1500, "b2": 1500, "c3": 500, "root0": 1000,
                  "root4": 900}
    assert round(idle.outside_s * 1e9) == 1000        # between the roots
    assert round(idle.idle_s * 1e9) == 1500 + 1500 + 500 + 1000 + 900 + 1000
    assert round(idle.window_s * 1e9) == 12000
    assert round(idle.inside(rec, lambda n: n == "b") * 1e9) == 2000
    names = dict(idle.by_name(rec))
    assert round(names["root"] * 1e9) == 1900 and names["-"] > 0


def test_a_device_operation_over_every_gap_leaves_no_idle():
    rec = _record([("root", -1, 0, 100, 0, None)])
    idle = recorded.Idle(rec, [[-5, 40], [40, 200]])
    assert idle.idle_s == 0.0 and idle.by_name(rec) == []


class _Ctx:
    def __init__(self, kind, rec):
        self.kind, self.recorded = kind, rec


def _recorded(rec4, rec5=None, busy=()):
    rec5 = rec5 if rec5 is not None else rec4
    return recorded.Recorded(rec4, {"window1": 50.0, "off": 60.0,
                                    "window4": 61.2}, rec5,
                             recorded.Idle(rec5, list(busy)))


@pytest.mark.parametrize("name,want", [
    ("host_enqueue_ms.serve", ((10 - 3) + (6 - 2)) / 2 * 1e-3),
    ("device_wait_ms.serve", (3 + 2) / 2 * 1e-3),
    ("host_syncs.serve", (2 + 1 + 3) / 2),
    # the whole record idle: the backbone span's 2 us in the first batch
    ("backbone_idle_ms.serve", 2e-3 / 2),
])
def test_serve_readers_on_a_synthetic_record(name, want):
    got = spec.reader(name)(_Ctx("serve", _recorded(_serve_record())))
    assert got == pytest.approx(want, rel=1e-9)
    assert spec.reader(name)(_Ctx("train", _recorded(_serve_record()))) \
        is None


def _train_record():
    return _record([
        ("ait:train_step", -1, 0, 50000, 0, None),
        ("ait:h2d", 0, 0, 10000, 0, {"host_syncs": 4}),
        ("ait:backward", 0, 20000, 40000, 0, {"host_syncs": 1}),
        ("ait:train_step", -1, 60000, 90000, 1, None),
        ("ait:h2d", 3, 60000, 61000, 1, {"host_syncs": 4}),
        ("ait:backward", 3, 70000, 80000, 1, None)])


@pytest.mark.parametrize("name,want", [
    ("host_step_ms.train", (50 + 30) / 2 * 1e-3),
    ("host_syncs.train", (4 + 1 + 4) / 2),
    # busy over [20, 35] us of the first backward: 5 + 10 us idle
    ("backward_idle_ms.train", (5 + 10) / 2 * 1e-3),
])
def test_train_readers_on_a_synthetic_record(name, want):
    rec = _recorded(_train_record(), busy=[[20000, 35000]])
    assert spec.reader(name)(_Ctx("train", rec)) == pytest.approx(
        want, rel=1e-9)
    assert spec.reader(name)(_Ctx("serve", rec)) is None


@pytest.mark.parametrize("name", [m["name"] for m in recorded.METRICS])
def test_a_run_without_a_record_reads_nothing(name):
    class Plain:                    # run.ReadCtx's fields, no record
        kind = name.rsplit(".", 1)[1]
        steps, busy_s, window_s, plain_window_s = 2, 0.5, 2.0, 1.6

    assert spec.reader(name)(Plain()) is None


def test_the_metrics_fit_the_benchmarks_form():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    layers = {m["layer"] for m in bench["per_layer"]}
    for m in recorded.METRICS:
        assert set(m["workloads"]) <= cells
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(e2e[m["moves"]]["workloads"])
        assert m["layer"] in layers | {"entry"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics",
                                           m["name"] + ".py"))


def test_syncs_by_span_and_breakdown():
    rec = _recorded(_serve_record())
    assert rec.syncs_by_span() == [["ait:d2h", 4], ["ait:backbone.image", 2],
                                   ["-", 1]]
    assert set(rec.breakdown()) == {"idle_by_span", "syncs_by_span",
                                    "ms_a_step"}


def test_the_cost_of_tracing_and_the_slowdown_after_profiling():
    rec = _recorded(_serve_record())
    assert rec.tracing_cost_pct() == pytest.approx(2.0)     # 61.2 / 60
    assert rec.slowdown_pct() == pytest.approx(20.0)        # 60 / 50


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_windows_4_and_5_after_the_three_on_a_tiny_cell(kind, monkeypatch):
    """On the CPU: `_traced`'s three windows run as they did (their keys
    and steps), window 4 (2n steps, between two off windows of n) and
    window 5 (n) record one root a step, and the readers find their
    numbers."""
    cell = tiny_cell(kind)
    n = int(cell.traffic["trace_batches"])
    seen = []
    orig = serve._traced

    def spy(step, n_, device):
        out = orig(lambda i: (seen.append(i), step(i)), n_, device)
        seen.append("end")
        return out

    monkeypatch.setattr(serve, "_traced", recorded.traced(spy))
    kind_mod = serve if kind == "serve" else train
    out = kind_mod.run(cell, 2 ** 31 + 7, 0.5, True, time.monotonic(),
                       device="cpu")
    first = serve.TRACE_WAIT + serve.TRACE_WARMUP
    three = first + 3 * n + 1
    assert seen == list(range(three)) + ["end"]
    assert out["attempted"] == int(cell.traffic["batch"]) * (
        three + 5 * n + first)
    rec = out["recorded"]
    root = "ait:predict" if kind == "serve" else "ait:train_step"
    assert [s.name for s in rec.record4.roots()] == [root] * (2 * n)
    assert [s.name for s in rec.record5.roots()] == [root] * n
    ids4 = [s.id for s in rec.record4.roots()]
    assert ids4 == sorted(ids4) and len(set(ids4)) == 2 * n
    ms = rec.ms_a_step
    assert set(ms) == {"window1", "off", "window4"}
    assert min(ms.values()) > 0
    assert ms["window1"] == pytest.approx(1e3 * out["plain_window_s"] / n)
    # no device: the whole window is idle, almost all of it in spans
    assert rec.idle.idle_s == pytest.approx(rec.idle.window_s)
    assert rec.idle.outside_s < 0.2 * rec.idle.idle_s
    ctx = run_recorded.RecordCtx(kind, rec)
    for m in recorded.METRICS:
        got = spec.reader(m["name"])(ctx)
        if m["name"].endswith("." + kind):
            assert got is not None and got >= 0.0, m["name"]
            if "syncs" in m["name"]:
                assert got == 0.0           # no CUDA device, no sync
        else:
            assert got is None
    bd = rec.breakdown()
    assert bd["syncs_by_span"] == []
    assert bd["idle_by_span"][0][1] > 0
