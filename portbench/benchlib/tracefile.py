"""Reduction of a torch.profiler chrome trace to the numbers the per-layer
readers take.

Device operations are the trace's kernels, copies and sets.  A device
operation belongs to a range (a `record_function` of the benchmark's
probes) when the host call that launched it, matched by its correlation id,
started inside that range on the same thread.  The traced window runs from
the first ProfilerStep's start to the end of the last step or of the last
device operation, whichever is later (without steps, from the first
device operation's start).
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(intervals: List[Tuple[float, float]]):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    def __init__(self, events: List[dict]):
        self.device: List[Tuple[float, float, str, Optional[int]]] = []
        launches: Dict[int, Tuple[int, float]] = {}
        self.ranges: List[Tuple[str, int, float, float]] = []
        steps: List[Tuple[float, float]] = []
        self.host_ops: Dict[int, List[Tuple[float, float, str]]] = \
            defaultdict(list)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            args = e.get("args", {})
            if cat in DEVICE_CATS:
                self.device.append((ts, ts + dur, name,
                                    args.get("correlation")))
            elif "correlation" in args:      # a host call that launched
                launches[args["correlation"]] = (e["tid"], ts)
            elif cat == "user_annotation":
                if name.startswith("ProfilerStep#"):
                    steps.append((ts, ts + dur))
                elif name.startswith("pb:"):
                    self.ranges.append((name, e["tid"], ts, ts + dur))
            elif cat == "cpu_op":
                self.host_ops[e["tid"]].append((ts, ts + dur, name))
        self.steps = sorted(steps)
        ends = [e for _, e in self.steps] + [e for _, e, _, _ in self.device]
        starts = [s for s, _ in self.steps] or [s for s, _, _, _ in
                                                self.device]
        if not starts:
            raise ValueError("the trace holds no step and no device work")
        self.t0, self.t1 = min(starts), max(ends)
        self.device = [d for d in self.device if d[1] > self.t0]
        # launches by thread, in time order, with the device seconds each
        # launched
        secs = defaultdict(float)
        for s, e, _, corr in self.device:
            if corr is not None:
                secs[corr] += (e - s) * 1e-6
        by_tid = defaultdict(list)
        for corr, (tid, ts) in launches.items():
            if corr in secs:
                by_tid[tid].append((ts, secs[corr]))
        self._launch_ts, self._launch_cum = {}, {}
        for tid, lst in by_tid.items():
            lst.sort()
            cum, acc = [0.0], 0.0
            for _, s in lst:
                acc += s
                cum.append(acc)
            self._launch_ts[tid] = [t for t, _ in lst]
            self._launch_cum[tid] = cum

    @classmethod
    def from_file(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy(self) -> List[List[float]]:
        return _union([(max(s, self.t0), min(e, self.t1))
                       for s, e, _, _ in self.device if e > s])

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) * 1e-6

    def device_s_in(self, tid: int, start: float, end: float) -> float:
        """Device seconds of the operations launched on `tid` in
        [start, end]."""
        ts = self._launch_ts.get(tid)
        if not ts:
            return 0.0
        cum = self._launch_cum[tid]
        return cum[bisect.bisect_right(ts, end)] - cum[
            bisect.bisect_left(ts, start)]

    def ranges_named(self, prefix: str):
        """(name, device seconds launched inside) of every range whose name
        is `prefix` or starts with `prefix + '|'`."""
        return [(n, self.device_s_in(tid, s, e))
                for n, tid, s, e in self.ranges
                if n == prefix or n.startswith(prefix + "|")]

    def top_device_ops(self, k: int = 10):
        tot = defaultdict(float)
        for s, e, name, _ in self.device:
            tot[name[:160]] += (e - s) * 1e-6
        return sorted(([n, v] for n, v in tot.items()),
                      key=lambda x: -x[1])[:k]

    def idle_gaps(self, k: int = 10):
        """The window's idle time on the device, summed by what the host
        was doing at each gap's middle (`_label`)."""
        busy = self.busy()
        gaps, prev = [], self.t0
        for s, e in busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        ranges = sorted((s, e, n.split("|")[0]) for n, _, s, e in self.ranges)
        r_start = [r[0] for r in ranges]
        tops = []
        for ops in self.host_ops.values():
            end = -1.0
            for s, e, n in sorted(ops):
                if s >= end:
                    tops.append((s, e, n))
                    end = e
        tops.sort()
        t_start = [o[0] for o in tops]
        tot = defaultdict(float)
        for s, e in gaps:
            tot[_label(0.5 * (s + e), ranges, r_start, tops, t_start)] += \
                (e - s) * 1e-6
        return sorted(([n, v] for n, v in tot.items()),
                      key=lambda x: -x[1])[:k]


def _label(t, ranges, r_start, tops, t_start, scan=256):
    """What the host was doing at time t: the innermost benchmark range
    holding it (the latest-starting one that does) and the top-level host
    operation holding it, "-" for either that is missing."""
    where = what = "-"
    i = bisect.bisect_right(r_start, t)
    for j in range(i - 1, max(-1, i - 1 - scan), -1):
        if ranges[j][1] >= t:
            where = ranges[j][2]
            break
    i = bisect.bisect_right(t_start, t)
    for j in range(i - 1, max(-1, i - 1 - scan), -1):
        if tops[j][1] >= t:
            what = tops[j][2]
            break
    return f"{where} {what}"
