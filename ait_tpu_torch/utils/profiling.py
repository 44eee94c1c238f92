"""Profiling helpers (counterpart of ait_tpu/utils/profiling.py).

`timed` wall-times a block and, given tensors, waits for their device
first, so a span under asynchronous CUDA launches means what it says.
`device_trace` records a torch.profiler trace (CPU and, where present,
CUDA activity) into a directory, as a Chrome trace file.  `annotate` names
a range that shows in torch.profiler's events and, on a CUDA device, as an
NVTX range in Nsight.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _sync(tree) -> None:
    """Wait for every CUDA device that holds a tensor of `tree`."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def timed(name: str, results: Optional[dict] = None, sync=None):
    """Wall-time a block; `sync` is a tensor (or a dict, list or tuple of
    them) whose device is waited for before the clock is read.  With
    `results` the seconds add up under `name`, else they are printed."""
    t0 = time.perf_counter()
    yield
    if sync is not None:
        _sync(sync)
    dt = time.perf_counter() - t0
    if results is not None:
        results[name] = results.get(name, 0.0) + dt
    else:
        print(f"[timed] {name}: {dt * 1e3:.2f} ms", flush=True)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Record a torch.profiler trace of the block into
    `log_dir/trace.json` (open it in chrome://tracing or Perfetto).  Yields
    the profiler, whose `key_averages()` sums the events by name."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named range in torch.profiler's events and, when the current
    device is CUDA, in Nsight's NVTX ranges."""
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()
