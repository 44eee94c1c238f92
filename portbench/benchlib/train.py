"""A training cell: the program's train step, closed loop.

Set-up makes the weights on the card from the seed, builds the model, the
SGD optimizer of `make_optimizer` and the step of `make_train_step` at the
configuration's lr schedule, and a `torch.Generator` on the card seeded
from the seed.  It then drives that one step through its first
`check_steps` steps on the pool's first batches (which also builds every
kernel and sees every canvas bucket), keeping what the check compares: each
step's loss, the optimizer's momentum after the first step and the
parameters after the last.  The window goes on with the same step, model,
optimizer and generator, cycling through the pool, and ends at a
synchronize after its last step.
"""

from __future__ import annotations

import gc
import time
from typing import Dict

import numpy as np
import torch

from benchlib import judge, probes, serve, spec, traffic
from benchlib.weights import make_weights
from reference.params import frozen, param_shapes


def generator_seed(seed: int) -> int:
    """The step generator's seed, derived from the run's."""
    ss = np.random.SeedSequence([int(seed), 43])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _bucket_first(pool):
    """The pool with a batch of another canvas moved to second place, so
    that the check steps see every bucket before the window."""
    shapes = [b["image"].shape for b in pool]
    for i, s in enumerate(shapes):
        if s != shapes[0]:
            return [pool[0], pool[i]] + pool[1:i] + pool[i + 1:]
    return pool


def schedule_of(cell):
    """The program's lr schedule at the configuration's `train` group; the
    reference works out its own (reference.train.lrs)."""
    from ait_tpu_torch.train.optim import lr_schedule

    tr = cell.config["train"]
    return lr_schedule(tr["lr"], tr["steps_per_epoch"],
                       tr["lr_decay_step_epochs"], tr["gamma"])


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, t0: float,
        device="cuda") -> Dict:
    from ait_tpu_torch.models import AITDetector
    from ait_tpu_torch.train import make_train_step
    from ait_tpu_torch.train.optim import make_optimizer

    mix, cfg = cell.traffic, cell.cfg
    pc = spec.program_config(cfg)
    dtype = getattr(torch, cfg["tpu"]["compute_dtype"])
    weights = make_weights(param_shapes(cfg), seed, device)
    model = AITDetector(pc, dtype=dtype)
    model.load_state_dict(weights)
    del weights
    opt = make_optimizer(pc, model)
    n_check = int(mix["check_steps"])
    step_fn = make_train_step(model, opt, schedule_of(cell), device=device)
    pool = _bucket_first(traffic.make_batches(mix, seed, train=True))
    gen = torch.Generator(device=device).manual_seed(generator_seed(seed))

    pr, cap = probes.Probes(), probes.Capture()
    cap.install(pr)
    if trace:
        probes.install_ranges(pr, model)

    named = dict(model.named_parameters())
    losses, buf1 = [], None
    cap.on = True
    for k in range(n_check):
        m = step_fn(pool[k], gen)
        losses.append(m["loss"].detach().float())
        if k == 0:
            buf1 = {n: opt.state[p]["momentum_buffer"].detach().clone()
                    for n, p in named.items() if p in opt.state}
    cap.on = False
    params = {n: p.detach().clone() for n, p in named.items()
              if not frozen(n)}
    serve._sync(device)
    setup_s = time.monotonic() - t0

    b = int(mix["batch"])

    def step(i):
        step_fn(pool[(n_check + i) % len(pool)], gen)

    out = {"metrics": {}, "device": {}}
    if not trace:
        i = 0
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            step(i)
            i += 1
        serve._sync(device)
        window = time.perf_counter() - start
        out["attempted"] = b * i
        e2e = {"train_pairs_per_s": (b * i / window, "pairs/s"),
               "setup_s": (setup_s, "s")}
        for m in cell.end_to_end:
            v, unit = e2e[m["name"]]
            out["metrics"][m["name"]] = {"value": v, "unit": unit}
    else:
        n = int(mix["trace_batches"])
        out.update(serve._traced(step, n, device))
        out["attempted"] = b * out.pop("steps_run")
        from benchlib.counts import model_flops
        canvas_hw = serve._rgb_hw(pool[0]["image"].shape, mix)
        out["flops_per_batch"] = model_flops(
            cfg, canvas_hw, b, cfg["TRAIN"]["BATCH_SIZE"], True)
    out["device"]["memory_peak_bytes"] = serve._peak(device)
    pr.undo()
    del step_fn, opt, model, named
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out["judged"] = judge.judge_train(
        cell, seed, pool[:n_check], cap.records, [float(x) for x in losses],
        buf1, params, generator_seed(seed), device)
    return out
