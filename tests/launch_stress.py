"""Stress `run_local`'s rendezvous under load, as the tier-1 run loads it.

    python tests/launch_stress.py [--repo DIR] [--loops 6] [--calls 40]
                                  [--burners 16]

starts `--burners` busy-loop processes and `--loops` processes that each
import JAX as tests/conftest.py does and then call
`run_local(torch_parallel_workers.loaded_modules, 2, device="cpu")`
`--calls` times in turn, as `test_spawned_ranks_load_no_jax` calls it
(that worker runs no collective).  `--repo` is the checkout whose port
and tests are driven (default: this one), so a second checkout, such as
a parent commit's, runs under the same load.  Prints every failed call's
message, then `RESULT <failed> failed of <calls> calls ...`; exits 1 if
any call failed.  Not collected by pytest; run it on a host with no other
heavy work, since the load is the point.
"""

import argparse
import multiprocessing as mp
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def burn(stop):
    x = 0
    while not stop.is_set():
        for i in range(100000):
            x += i * i


def loop(repo, calls, out):
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path[:0] = [repo, os.path.join(repo, "tests")]
    os.chdir(repo)
    import conftest  # noqa: F401  (JAX in the caller, as in the test)
    import torch_parallel_workers as workers

    for i in range(calls):
        t0 = time.monotonic()
        try:
            ranks = workers.run(workers.loaded_modules, 2, timeout=120)
            ok, msg = len({pid for _, pid in ranks}) == 2, "one pid"
        except Exception as e:          # counted and printed by the parent
            ok, msg = False, str(e)
        out.put((os.getpid(), i, ok, time.monotonic() - t0, msg))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=HERE)
    ap.add_argument("--loops", type=int, default=6)
    ap.add_argument("--calls", type=int, default=40)
    ap.add_argument("--burners", type=int, default=16)
    a = ap.parse_args(argv)
    ctx = mp.get_context("spawn")
    stop, out = ctx.Event(), ctx.Queue()
    burners = [ctx.Process(target=burn, args=(stop,))
               for _ in range(a.burners)]
    loops = [ctx.Process(target=loop, args=(os.path.abspath(a.repo),
                                            a.calls, out))
             for _ in range(a.loops)]
    t0 = time.monotonic()
    for p in burners + loops:
        p.start()
    failed = 0
    try:
        for _ in range(a.loops * a.calls):
            pid, i, ok, s, msg = out.get(timeout=600)
            if not ok:
                failed += 1
                print(f"FAIL loop {pid} call {i} after {s:.1f} s:\n{msg}\n",
                      flush=True)
    finally:
        stop.set()
        for p in loops + burners:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    print(f"RESULT {failed} failed of {a.loops * a.calls} calls, {a.loops} "
          f"loops x {a.calls} calls, {a.burners} burners, {os.cpu_count()} "
          f"cores, {time.monotonic() - t0:.0f} s", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
