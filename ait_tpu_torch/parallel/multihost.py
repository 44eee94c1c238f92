"""Process-level glue of the multi-process CLIs (counterpart of
ait_tpu/parallel/multihost.py).

The port runs one process per device (torchrun): every rank runs the same
program on its own rows, the loader feeds each data rank only its slice
(data/loader.py, `process_index` / `process_count`), and these helpers do
the rest: the process group from torchrun's environment, a rank's rows of
a batch, and object merging across ranks.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from ait_tpu_torch.device import resolve_device


def maybe_init_distributed(log=print, device=None) -> Optional[torch.device]:
    """Join the process group when torchrun launched this process (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT in the environment):
    NCCL on cuda:LOCAL_RANK, or gloo when `device` names the CPU.  Returns
    this rank's device; without that environment (or when the group exists
    already) it does nothing and returns None."""
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ \
            or dist.is_initialized():
        return None
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", "0"))
    dev = resolve_device(device)
    if dev.type == "cuda":
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"LOCAL_RANK {local}: this host has "
                f"{torch.cuda.device_count()} CUDA devices and NCCL takes "
                "one rank a device")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, rank=rank, world_size=world)
    log(f"torch.distributed initialized: rank {rank}/{world} ({backend}, "
        f"{dev})")
    return dev


def world() -> tuple:
    """(rank, world size) of the initialized group; (0, 1) without one."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def host_local_rows(arr) -> np.ndarray:
    """This rank's rows of a batch, as numpy: a rank holds only its own
    rows, so they pass through whole."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def allgather_object(obj: Any, group=None) -> list:
    """Every rank's `obj`, as a list indexed by rank (one pickled
    all-gather); [obj] without a process group or at world 1."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return [obj]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def merge_all_boxes(parts: list) -> dict:
    """Union of per-rank all_boxes[class][record_index] dicts (disjoint by
    construction across data ranks: each pair is evaluated by one data
    rank, and its seq ranks hold the same result)."""
    merged: dict = {}
    for part in parts:
        for ci, recs in part.items():
            merged.setdefault(ci, {}).update(recs)
    return merged
