"""Where the port's entry points run."""

from __future__ import annotations

import functools

import torch


def resolve_device(device=None) -> torch.device:
    """The GPU unless the caller names a device; no GPU and no device named
    is an error, never a quiet run on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "port on the CPU")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _device_sms(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def device_sms(device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return _device_sms(device.index if device.index is not None
                       else torch.cuda.current_device())
