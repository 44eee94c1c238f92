"""The program's own record (ait_tpu_torch.utils.profiling) in a traced
run: unprofiled windows around window 4, then window 5, after
`serve._traced`'s three.

- Window 4 is 2n steps with the recorder on, unprofiled, between two
  windows of n steps with it off (off, on, off: a drift of the host's
  speed over the three cancels to first order).  Its spans give the host's
  times a step (`ait:predict`, `ait:d2h`, `ait:train_step`) and its
  `host_syncs` counts the blocking syncs a step, by span.  Its time a step
  against the off windows' is what tracing costs when on; the off windows'
  against window 1's (the same steps before any profiling) is how much
  slower the host runs after the profiled windows, which window 4's host
  times carry too.
- Window 5 profiles CUDA activity alone, after the profiler's own warm-up,
  as window 2 does; the recorder is on over its n active steps only.  Each
  idle interval of the device there (a gap in the union of its kernels,
  copies and sets, between the first root span's start and the last one's
  end) is split exactly among the innermost program spans open over it
  (`Idle`).

A span's times are on `time.time_ns()`, the clock of the profiler's
exported traces (`ts` in us x 1000 + `baseTimeNanoseconds`).  `traced`
wraps `_traced`, whose three windows run as they did; the readers in
portbench/metrics/ of the metrics in `METRICS` read a `Recorded`, and find
nothing (None) where a run made no record.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

from benchlib.tracefile import DEVICE_CATS, _union

# the per-layer metrics read from the record, as BENCHMARK.json entries
SERVE = ["res50_serve_b8", "res101ls_serve_b8"]
TRAIN = ["res50_train_b8"]
METRICS = [
    dict(name=name, unit=unit, better="lower", source=source, layer=layer,
         moves=moves, workloads=cells)
    for name, unit, source, layer, moves, cells in [
        ("host_enqueue_ms.serve", "ms", "host_clock", "entry",
         "serve_pairs_per_s", SERVE),
        ("device_wait_ms.serve", "ms", "host_clock", "entry",
         "serve_batch_ms_p95", SERVE),
        ("host_syncs.serve", "count", "host_clock", "entry",
         "serve_pairs_per_s", SERVE),
        ("backbone_idle_ms.serve", "ms", "device_trace", "model step",
         "serve_pairs_per_s", SERVE),
        ("host_step_ms.train", "ms", "host_clock", "entry",
         "train_pairs_per_s", TRAIN),
        ("host_syncs.train", "count", "host_clock", "entry",
         "train_pairs_per_s", TRAIN),
        ("backward_idle_ms.train", "ms", "device_trace", "model step",
         "train_pairs_per_s", TRAIN)]]
SYNCS = "host_syncs"
OUTSIDE = "-"          # idle time while no program span was open


def _segments(spans):
    """[start, end, innermost open span's index or None] between
    consecutive span boundaries, from the first to the last; the innermost
    open span is the latest-started one still open."""
    starts, ends = defaultdict(list), defaultdict(list)
    for i, s in enumerate(spans):
        if s.end_ns > s.start_ns:
            starts[s.start_ns].append(i)
            ends[s.end_ns].append(i)
    segs, open_, prev = [], set(), None
    for t in sorted(set(starts) | set(ends)):
        if prev is not None:
            inner = max(open_, key=lambda i: (spans[i].start_ns, i),
                        default=None)
            segs.append((prev, t, inner))
        open_.difference_update(ends[t])
        open_.update(starts[t])
        prev = t
    return segs


class Idle:
    """The device's idle time over a record's root spans, split among the
    innermost program spans open over it: `by_span[i]` seconds to span i,
    `outside_s` to no span; `idle_s` their sum, `window_s` the first root's
    start to the last root's end.  `device_ns`: the device operations'
    [start, end] on time.time_ns()."""

    def __init__(self, rec, device_ns: List[List[float]]):
        self.by_span: Dict[int, float] = defaultdict(float)
        self.outside_s = self.idle_s = self.window_s = 0.0
        roots = [s for s in rec.roots() if s.end_ns]
        if not roots:
            return
        t0 = min(s.start_ns for s in roots)
        t1 = max(s.end_ns for s in roots)
        self.window_s = (t1 - t0) * 1e-9
        gaps, prev = [], t0
        for s, e in _union([(max(s, t0), min(e, t1)) for s, e in device_ns
                            if min(e, t1) > max(s, t0)]):
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if t1 > prev:
            gaps.append((prev, t1))
        segs, k = _segments(rec.spans), 0
        for s, e in gaps:                # both sorted: one pass
            while k < len(segs) and segs[k][1] <= s:
                k += 1
            j = k
            while j < len(segs) and segs[j][0] < e:
                sec = (min(e, segs[j][1]) - max(s, segs[j][0])) * 1e-9
                if sec > 0:
                    self.idle_s += sec
                    if segs[j][2] is None:
                        self.outside_s += sec
                    else:
                        self.by_span[segs[j][2]] += sec
                j += 1

    def inside(self, rec, pred: Callable[[str], bool]) -> float:
        """Idle seconds attributed to spans that are, or lie inside, a span
        whose name satisfies pred."""
        return sum(sec for i, sec in self.by_span.items()
                   if _within(rec, i, pred))

    def by_name(self, rec, k: int = 10):
        """The top k [span name, idle seconds], OUTSIDE for no span."""
        tot = defaultdict(float)
        for i, sec in self.by_span.items():
            tot[rec.spans[i].name] += sec
        if self.outside_s:
            tot[OUTSIDE] += self.outside_s
        return _top(tot, k)


def _within(rec, i: int, pred) -> bool:
    while i >= 0:
        if pred(rec.spans[i].name):
            return True
        i = rec.spans[i].parent
    return False


def _top(tot, k):
    return sorted(([n, v] for n, v in tot.items()), key=lambda x: -x[1])[:k]


class Recorded:
    """What windows 4 and 5 recorded: `record4` (window 4's record),
    `ms_a_step` (host-clock ms a step of "window1", of the "off" windows
    around window 4 and of "window4"), `record5` and `idle` (window 5's
    record and its idle attribution).  A record's roots are its steps
    (`ait:predict` or `ait:train_step`)."""

    def __init__(self, record4, ms_a_step, record5, idle):
        self.record4, self.ms_a_step = record4, ms_a_step
        self.record5, self.idle = record5, idle

    def tracing_cost_pct(self) -> float:
        """Window 4's time a step over the off windows' around it, -1, %."""
        ms = self.ms_a_step
        return 100.0 * (ms["window4"] / ms["off"] - 1.0)

    def slowdown_pct(self) -> float:
        """The off windows' time a step over window 1's, -1, %: how much
        slower the host runs after the profiled windows."""
        ms = self.ms_a_step
        return 100.0 * (ms["off"] / ms["window1"] - 1.0)

    def mean_ms(self, of: Callable) -> Optional[float]:
        """Mean over window 4's steps of of(record, root), ns -> ms."""
        rec = self.record4
        roots = rec.roots()
        if not roots:
            return None
        return 1e-6 * sum(of(rec, r) for r in roots) / len(roots)

    def syncs_a_step(self) -> Optional[float]:
        rec = self.record4
        roots = rec.roots()
        if not roots:
            return None
        return sum(s.counts.get(SYNCS, 0) for s in rec.spans) / len(roots)

    def idle_ms_inside(self, pred) -> Optional[float]:
        """Window 5's device-idle ms a step inside spans matching pred."""
        roots = self.record5.roots()
        if not roots:
            return None
        return 1e3 * self.idle.inside(self.record5, pred) / len(roots)

    def syncs_by_span(self, k: int = 10):
        """The top k [span name, host_syncs in window 4]."""
        tot = defaultdict(int)
        for s in self.record4.spans:
            if s.counts.get(SYNCS):
                tot[s.name] += s.counts[SYNCS]
        if self.record4.counts.get(SYNCS):
            tot[OUTSIDE] += self.record4.counts[SYNCS]
        return _top(tot, k)

    def breakdown(self) -> Dict:
        return {"idle_by_span": self.idle.by_name(self.record5),
                "syncs_by_span": self.syncs_by_span(),
                "ms_a_step": dict(self.ms_a_step)}


def under_ns(rec, root, name: str) -> int:
    """Summed length of the spans called `name` under `root`."""
    i = rec.spans.index(root)
    return sum(s.dur_ns for s in rec.spans if s.root == i and s.name == name)


def device_intervals_ns(doc: Dict) -> List[List[float]]:
    """The device operations of a Chrome trace, on time.time_ns()."""
    base = float(doc.get("baseTimeNanoseconds", 0))
    return [[base + 1e3 * float(e["ts"]),
             base + 1e3 * (float(e["ts"]) + float(e.get("dur", 0.0)))]
            for e in doc["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def _timed(step, steps, device, sync) -> float:
    """Host-clock seconds to run `steps` of `step` to a synchronize."""
    sync(device)
    start = time.perf_counter()
    for i in steps:
        step(i)
    sync(device)
    return time.perf_counter() - start


def windows(step, n: int, device, sync, wait: int, warmup: int):
    """The off window, window 4 (2n steps), the off window and window 5,
    steps 0 .. (5n + wait + warmup - 1) of `step`; returns (Recorded
    without "window1" in `ms_a_step`, steps run)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from ait_tpu_torch.utils.profiling import recording

    off_s = _timed(step, range(n), device, sync)
    with recording() as rec4:
        w4 = _timed(step, range(n, 3 * n), device, sync)
    off_s += _timed(step, range(3 * n, 4 * n), device, sync)
    ms = {"off": 1e3 * off_s / (2 * n), "window4": 1e3 * w4 / (2 * n)}

    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    path = os.path.join(tempfile.gettempdir(),
                        f"portbench_{os.getpid()}_recorded.json")
    first = wait + warmup
    try:
        with profile(activities=acts,
                     schedule=schedule(wait=wait, warmup=warmup, active=n),
                     on_trace_ready=lambda p: p.export_chrome_trace(
                         path)) as prof, contextlib.ExitStack() as on:
            for i in range(first + n):
                if i == first:
                    sync(device)
                    rec5 = on.enter_context(recording())
                step(4 * n + i)
                if i == first + n - 1:
                    sync(device)
                    on.close()
                prof.step()
        with open(path) as f:
            doc = json.load(f)
    finally:
        if os.path.exists(path):
            os.remove(path)
    idle = Idle(rec5, device_intervals_ns(doc))
    return Recorded(rec4, ms, rec5, idle), 5 * n + first


def traced(orig: Callable) -> Callable:
    """`_traced` with the windows of `windows` after the three of `orig`;
    its result gains "recorded", a `Recorded`."""

    def run(step, n: int, device) -> Dict:
        from benchlib import serve

        out = orig(step, n, device)
        k = out["steps_run"]
        rec, used = windows(lambda i: step(k + i), n, device, serve._sync,
                            serve.TRACE_WAIT, serve.TRACE_WARMUP)
        rec.ms_a_step["window1"] = 1e3 * out["plain_window_s"] / n
        out["recorded"] = rec
        out["steps_run"] = k + used
        return out

    return run
