"""Rank workers of tests/test_torch_parallel_launch.py.

They hold the launcher alone (`ait_tpu_torch.parallel.launch.run_local`),
so this module imports nothing but the launcher: a spawned rank reaches its
worker in the time it takes to import torch.  No worker here runs a
collective, so nothing but the launcher holds the ranks together.
"""

from __future__ import annotations

import os

from ait_tpu_torch.parallel import launch


def run(fn, world, *args, timeout=120.0):
    """run_local on the CPU under gloo with these tests' timeout."""
    return launch.run_local(fn, world, backend="gloo", device="cpu",
                            timeout=timeout, args=args)


def whoami(rank, world, dev):
    return rank, world, str(dev), os.getpid()


def raise_alone(rank, world, dev, bad):
    """Rank `bad` raises; every other rank returns at once."""
    if rank == bad:
        raise ValueError(f"boom on rank {rank}")
    return rank


def exit_alone(rank, world, dev, bad, code):
    """Rank `bad` dies with `code` and reports nothing; the others return."""
    if rank == bad:
        os._exit(code)
    return rank
