"""The port's launcher, `ait_tpu_torch/parallel/launch.py::run_local`, on
gloo groups of the CPU (workers in tests/torch_launch_workers.py).

* ranks that run no collective: several calls at once from threads, in
  rounds, at world 2 and at world 4; every call returns every rank's result
  (a rank that closed its group while its peer was still forming it failed
  the peer's init with "Connection closed by peer");
* `store_barrier`: no rank leaves before the last arrives;
* a failed call names every rank's outcome: a traceback beside "returned a
  result", and "exited with code N without a result";
* no `device` means the card: without one, "no CUDA device", raised before
  any rank is spawned.
"""

import multiprocessing
import threading
import time

import pytest
import torch
import torch.distributed as dist

import torch_launch_workers as workers
from ait_tpu_torch.parallel import launch


@pytest.mark.parametrize("world,calls,rounds", [(2, 4, 3), (4, 2, 1)])
def test_concurrent_calls_without_collectives_return_every_rank(
        world, calls, rounds):
    for _ in range(rounds):
        got, errors = {}, []

        def call(i):
            try:
                got[i] = workers.run(workers.whoami, world)
            except BaseException as e:      # re-raised below, in the test
                errors.append(e)

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(calls)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors
        assert sorted(got) == list(range(calls))
        for ranks in got.values():
            assert [r[:3] for r in ranks] == [(r, world, "cpu")
                                              for r in range(world)]
            assert len({r[3] for r in ranks}) == world


def test_store_barrier_holds_every_rank_until_the_last_arrives():
    store = dist.HashStore()
    left = {}

    def rank(r):
        time.sleep(0.2 * r)
        launch.store_barrier(store, "b", 3)
        left[r] = time.monotonic()

    t0 = time.monotonic()
    threads = [threading.Thread(target=rank, args=(r,)) for r in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(left) == [0, 1, 2]
    assert min(left.values()) - t0 >= 0.4


def test_a_failed_call_names_every_rank_outcome():
    with pytest.raises(RuntimeError, match=(
            r"(?s)rank 0 returned a result\nrank 1 raised:\n"
            r"Traceback.*ValueError: boom on rank 1")):
        workers.run(workers.raise_alone, 2, 1, timeout=60)
    with pytest.raises(RuntimeError, match=(
            r"rank 0 returned a result\n"
            r"rank 1 exited with code 3 without a result")):
        workers.run(workers.exit_alone, 2, 1, 3, timeout=60)


def test_no_device_means_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = set(multiprocessing.active_children())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.run_local(workers.whoami, 2, timeout=60)
    assert set(multiprocessing.active_children()) == before
