"""Profiling helpers (counterpart of ait_tpu/utils/profiling.py): the
program's own spans and counters, and a torch.profiler exporter.

    with recording() as rec:          # off by default
        with annotate("ait:predict", id=batch):
            count("host_syncs")
    rec.spans                          # Span records, in the order opened

`annotate(name, id=None)` is the program's span and `count(name, n=1)` its
counter.  Outside `recording()` annotate returns one shared no-op context and
count returns at once: nothing is allocated and no torch call is made.
Inside it a span keeps its name, its start and end on `time.time_ns()`, the
index of its parent span (a stack per thread), its thread, and the id of its
root span; a count adds to the innermost span open on the calling thread
(to `Record.counts` where none is).  `time.time_ns()` is torch.profiler's
clock: an exported Chrome trace event's `ts` (us) x 1000 plus the trace's
`baseTimeNanoseconds` lies on it, so every device interval of a profiled
window can be set against the spans recorded in it.

While recording with a CUDA device present, every synchronizing CUDA call
that torch reports (`torch.cuda.set_sync_debug_mode("warn")`: a blocking
copy between host and device, `.item()`, `nonzero`) counts one
`host_syncs` where it was made; warnings raised in autograd's backward
threads reach the caller when `.backward()` returns, so they count in the
span around it.  `torch.cuda.synchronize()` is not reported.

`device_trace` records a torch.profiler trace (CPU and, where present,
CUDA activity) of a block with the recorder on, into a directory as a
Chrome trace file that also holds the program's spans at their times.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import warnings
from typing import Dict, Iterator, List, Optional

import torch

# what torch says at a synchronizing CUDA call in its "warn" sync debug mode
SYNC_WARNING = "called a synchronizing CUDA operation"
# and what it says once the mode is set (the count is of what it reports)
PROTOTYPE_WARNING = "Synchronization debug mode is a prototype"

_record: Optional["Record"] = None     # the open recording, if any


class Span:
    """One recorded span.  `parent` and `root` index `Record.spans` (-1: no
    parent); `id` is the root span's id; `counts` the counts made while it
    was the innermost span open on its thread."""

    __slots__ = ("name", "id", "parent", "root", "thread", "start_ns",
                 "end_ns", "counts")

    def __init__(self, name, id, parent, root, thread, start_ns):
        self.name, self.id, self.parent, self.root = name, id, parent, root
        self.thread, self.start_ns = thread, start_ns
        self.end_ns = 0
        self.counts: Dict[str, int] = {}

    @property
    def dur_ns(self) -> int:
        return self.end_ns - self.start_ns


class Record:
    """The spans and counts of one recording."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counts: Dict[str, int] = {}    # counts made outside any span
        self._stacks: Dict[int, List[int]] = {}
        self._lock = threading.Lock()      # spans open on several threads

    def count(self, name: str, n: int = 1) -> None:
        stack = self._stacks.get(threading.get_ident())
        counts = self.spans[stack[-1]].counts if stack else self.counts
        counts[name] = counts.get(name, 0) + n

    def roots(self) -> List[Span]:
        return [s for s in self.spans if s.parent < 0]

    def chrome_events(self, base_ns: int, pid=0) -> List[dict]:
        """The spans as Chrome trace events on a trace whose
        `baseTimeNanoseconds` is base_ns."""
        return [{"ph": "X", "cat": "ait_span", "name": s.name, "pid": pid,
                 "tid": s.thread, "ts": (s.start_ns - base_ns) / 1e3,
                 "dur": s.dur_ns / 1e3,
                 "args": {"id": s.id, "index": i, "parent": s.parent,
                          **s.counts}}
                for i, s in enumerate(self.spans) if s.end_ns]


class _Open:
    """The context of one span of a recording."""

    __slots__ = ("rec", "name", "id", "index", "stack")

    def __init__(self, rec: Record, name: str, id):
        self.rec, self.name, self.id = rec, name, id

    def __enter__(self):
        rec = self.rec
        tid = threading.get_ident()
        stack = rec._stacks.get(tid)
        if stack is None:
            stack = rec._stacks[tid] = []
        with rec._lock:
            i = len(rec.spans)
            if stack:
                parent = rec.spans[stack[-1]]
                span = Span(self.name, parent.id, stack[-1], parent.root,
                            tid, 0)
            else:
                span = Span(self.name, self.id, -1, i, tid, 0)
            rec.spans.append(span)
        self.index, self.stack = i, stack
        stack.append(i)
        span.start_ns = time.time_ns()
        return span

    def __exit__(self, *exc):
        self.rec.spans[self.index].end_ns = time.time_ns()
        self.stack.pop()
        return False


_OFF = contextlib.nullcontext()


def annotate(name: str, id=None):
    """The program's span `name` (a root's `id`: its batch's or step's
    number); the shared no-op context when no recording is open."""
    rec = _record
    if rec is None:
        return _OFF
    return _Open(rec, name, id)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` of the innermost open span."""
    rec = _record
    if rec is not None:
        rec.count(name, n)


def is_recording() -> bool:
    """Whether a recording is open: a count that costs work to compute is
    computed only then."""
    return _record is not None


@contextlib.contextmanager
def recording() -> Iterator[Record]:
    """Turn the recorder on for the block; yields its Record."""
    global _record
    if _record is not None:
        raise RuntimeError("a recording is already open")
    rec = Record()
    cuda = torch.cuda.is_available()
    with warnings.catch_warnings():
        if cuda:
            prev_mode = torch.cuda.get_sync_debug_mode()
            shown = warnings.showwarning

            def show(message, category, *args, **kw):
                if str(message).startswith(SYNC_WARNING):
                    count("host_syncs")
                else:
                    shown(message, category, *args, **kw)

            # "always": a repeat from one site is reported again
            warnings.filterwarnings("always", message=SYNC_WARNING)
            warnings.filterwarnings("ignore", message=PROTOTYPE_WARNING)
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
        _record = rec
        try:
            yield rec
        finally:
            _record = None
            if cuda:
                torch.cuda.set_sync_debug_mode(prev_mode)


def merge_spans(path: str, rec: Record) -> None:
    """Add the recording's spans to the Chrome trace at `path`."""
    with open(path) as f:
        doc = json.load(f)
    pid = os.getpid()
    doc["traceEvents"].extend(
        rec.chrome_events(int(doc.get("baseTimeNanoseconds", 0)), pid))
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Record a torch.profiler trace of the block, with the recorder on,
    into `log_dir/trace.json` (open it in chrome://tracing or Perfetto),
    the program's spans among its events (category "ait_span").  Yields
    the profiler, whose `key_averages()` sums torch's events by name."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with recording() as rec:
        with profile(activities=activities) as prof:
            yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    merge_spans(path, rec)
