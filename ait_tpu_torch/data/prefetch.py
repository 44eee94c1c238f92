"""Device prefetch (counterpart of ait_tpu/data/prefetch.py): copy the next
batches to the device while the current step runs.

Each batch's arrays go into pinned host tensors and are copied on a side
CUDA stream with `non_blocking=True`, `size` batches ahead.  The consumer's
stream waits on a batch's copy event before the consumer gets the batch,
and `record_stream` keeps each tensor's memory from being reused while that
stream may still read it.  The queue is refilled when the consumer asks for
the next batch, so the host waits for the loader after the consumer's step
is queued, not before.  On the CPU the arrays only become tensors.
"""

from __future__ import annotations

import collections
import itertools
from typing import Any, Dict, Iterable, Iterator

import numpy as np
import torch

from ait_tpu_torch.device import resolve_device


def device_prefetch(batches: Iterable[Dict[str, Any]], size: int = 2,
                    device=None) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield each batch (a dict of numpy arrays) as tensors on `device` (the
    GPU unless named), in order, keeping `size` copies in flight."""
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    dev = resolve_device(device)
    it = iter(batches)

    if dev.type != "cuda":
        for batch in it:
            yield {k: torch.as_tensor(np.asarray(v), device=dev)
                   for k, v in batch.items()}
        return

    side = torch.cuda.Stream(device=dev)

    def put(batch):
        out = {}
        with torch.cuda.stream(side):
            for k, v in batch.items():
                host = torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                out[k] = host.to(dev, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        return out, done

    queue: collections.deque = collections.deque()

    def refill():
        # after a yield, so that the consumer's step is already queued on
        # the device while the host waits for the next batches
        for batch in itertools.islice(it, size - len(queue)):
            queue.append(put(batch))

    refill()
    while queue:
        out, done = queue.popleft()
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(done)
        for t in out.values():
            t.record_stream(consumer)
        yield out
        refill()
