"""Local multi-process runs over torch.distributed (the port's counterpart
of what tools/dryrun_multihost.py and __graft_entry__._dryrun_impl do for
JAX: several real processes of one program on one host).

    results = run_local(worker, 2, backend="gloo", device="cpu",
                        timeout=120, args=(x,))

spawns `world_size` processes; rank r runs `worker(r, world_size, device,
*args)` inside an initialized process group and sends back its return
value, which `run_local` returns in rank order.  The group meets through a
TCPStore that the caller's process serves for the whole call, on a port of
localhost that the store itself bound (port 0): the number reaches the
ranks only once it is held, so no other process, and no other `run_local`
running at the same time, can take it between its choice and its use.
A rank that raises is re-raised in the caller with its rank and traceback;
when `timeout` seconds pass first, every child is killed and TimeoutError
raised, so a hung collective never outlives the call.  The children are
spawned, not forked: each imports the worker's module afresh, so a worker
in a module that imports no JAX runs in a process that holds none.  Each
child runs one intra-op thread.

`device` is "cpu" or "cuda": with "cuda" rank r runs on card r modulo the
card count, so several ranks may share one card (under gloo; NCCL takes one
rank a card).
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import queue
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist


# seconds to wait for the other ranks' reports after one rank failed
_GRACE = 5.0


def _timeout(seconds: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=seconds)


def _rank_device(device: str, rank: int) -> torch.device:
    """The device of `rank`: the CPU, or card rank % cards."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _child(fn, rank, world_size, backend, device, port, timeout, args, out):
    try:
        torch.set_num_threads(1)
        dev = _rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        store = dist.TCPStore("127.0.0.1", port, is_master=False,
                              timeout=_timeout(timeout))
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world_size,
                                timeout=_timeout(timeout))
    except BaseException:  # reported to the parent, which re-raises it
        out.put((rank, False, traceback.format_exc()))
        return
    try:
        # the report goes out before the group closes: a closed group
        # breaks the peers' collectives, and their reports should follow
        out.put((rank, True, fn(rank, world_size, dev, *args)))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def run_local(fn: Callable, world_size: int, *, backend: str = "gloo",
              device: str = "cpu", timeout: float = 300.0,
              args: Sequence[Any] = ()) -> List[Any]:
    """[fn(rank, world_size, device, *args) for each rank], each in its own
    spawned process of one process group (module docstring)."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    # served here until every rank is done: the ranks connect as clients
    store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                          wait_for_workers=False, timeout=_timeout(timeout))
    port = store.port
    procs = [ctx.Process(target=_child, daemon=True,
                         args=(fn, r, world_size, backend, device, port,
                               timeout, tuple(args), out))
             for r in range(world_size)]
    for p in procs:
        p.start()
    results, errors = {}, {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) + len(errors) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                for r, p in enumerate(procs):
                    if r not in results and r not in errors and \
                            p.exitcode not in (None, 0):
                        errors[r] = (f"exited with code {p.exitcode} "
                                     "without a result")
                        deadline = min(deadline, time.monotonic() + _GRACE)
                continue
            if ok:
                results[rank] = value
            else:
                # a failed rank breaks its peers' collectives: collect their
                # reports a little longer, then report them all
                errors[rank] = value
                deadline = min(deadline, time.monotonic() + _GRACE)
    finally:
        for p in procs:
            p.join(timeout=10 if len(results) == world_size else 0)
            if p.is_alive():
                p.kill()
                p.join()
        out.close()
        del store
    if errors:
        raise RuntimeError("run_local: " + "\n".join(
            f"rank {r} raised:\n{tb}" for r, tb in errors.items()))
    if len(results) < world_size:
        missing = sorted(set(range(world_size)) - set(results))
        raise TimeoutError(f"run_local: ranks {missing} still running after "
                           f"{timeout} s; killed")
    return [results[r] for r in range(world_size)]
