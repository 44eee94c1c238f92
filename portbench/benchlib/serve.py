"""A serving cell: one client, closed loop.

The client sends the next batch of pairs to `OneShotPredictor.
predict_prepared` when the last one's detections have reached the host.
Set-up makes the weights on the card from the seed, builds the predictor,
makes the mix's pool of batches and serves every canvas bucket of the pool
twice, so that every kernel is built and every shape seen before the
window.  The window then cycles through the pool for `seconds`.  A sample
of the window's batches, drawn from the seed, is kept for the check.
"""

from __future__ import annotations

import gc
import os
import tempfile
import time
from typing import Dict

import numpy as np
import torch

from benchlib import judge, probes, spec, traffic
from benchlib.weights import make_weights
from reference.params import param_shapes

# batches a traced run profiles after its profiler's own warm-up steps
TRACE_WAIT, TRACE_WARMUP = 1, 2


def _sample(mix, seed, pool_canvases):
    """The window indices judged: `check` of the first 2 * pool, at least
    one of each canvas bucket."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 29]))
    n = int(mix["check"])
    span = 2 * len(pool_canvases)
    firsts, seen = [], set()
    for i in rng.permutation(span):
        c = pool_canvases[i % len(pool_canvases)]
        if c not in seen:
            seen.add(c)
            firsts.append(int(i))
    rest = [int(i) for i in rng.permutation(span) if int(i) not in firsts]
    return sorted((firsts + rest)[:max(n, len(firsts))])


def p95(values):
    """The nearest-rank 95th percentile."""
    v = sorted(values)
    return v[max(0, int(np.ceil(0.95 * len(v))) - 1)]


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, t0: float,
        device="cuda") -> Dict:
    from ait_tpu_torch.predict import OneShotPredictor

    mix, cfg = cell.traffic, cell.cfg
    pc = spec.program_config(cfg)
    dtype = getattr(torch, cfg["tpu"]["compute_dtype"])
    shapes = param_shapes(cfg)
    weights = make_weights(shapes, seed, device)
    predictor = OneShotPredictor(pc, weights, device=device, dtype=dtype)
    del weights
    pool = traffic.make_batches(mix, seed)
    canvases = [b["image"].shape for b in pool]
    sample = set(_sample(mix, seed, canvases))

    pr = probes.Probes()
    cap = probes.Capture()
    cap.install(pr)
    if trace:
        probes.install_ranges(pr, predictor.model)

    def serve(i):
        b = pool[i % len(pool)]
        cap.on = i in sample
        dets = predictor.predict_prepared(b["image"], b["query"],
                                          b["im_info"])
        if cap.on:
            cap.records[-1].update(dets=dets, batch=b)
        cap.on = False

    for shape in dict.fromkeys(canvases):
        first = canvases.index(shape)
        for _ in range(2):
            predictor.predict_prepared(pool[first]["image"],
                                       pool[first]["query"],
                                       pool[first]["im_info"])
    _sync(device)
    setup_s = time.monotonic() - t0

    out = {"metrics": {}, "device": {}}
    b = int(mix["batch"])
    if not trace:
        lat, i = [], 0
        start = time.perf_counter()
        while True:
            t = time.perf_counter()
            serve(i)
            lat.append(time.perf_counter() - t)
            i += 1
            if time.perf_counter() - start >= seconds:
                break
        window = time.perf_counter() - start
        out["attempted"] = b * i
        e2e = {"serve_pairs_per_s": (b * i / window, "pairs/s"),
               "serve_batch_ms_p95": (p95(lat) * 1e3, "ms"),
               "setup_s": (setup_s, "s")}
        for m in cell.end_to_end:
            v, unit = e2e[m["name"]]
            out["metrics"][m["name"]] = {"value": v, "unit": unit}
    else:
        n = int(mix["trace_batches"])
        out.update(_traced(serve, n, device))
        out["attempted"] = b * out.pop("steps_run")
        canvas_hw = _rgb_hw(canvases[0], mix)
        from benchlib.counts import model_flops
        out["flops_per_batch"] = model_flops(
            cfg, canvas_hw, b, cfg["TEST"]["RPN_POST_NMS_TOP_N"], False)
    out["device"]["memory_peak_bytes"] = _peak(device)
    pr.undo()
    del predictor
    gc.collect()
    torch.cuda.empty_cache()
    out["judged"] = _judge(cap.records, cell, seed, device)
    return out


def _traced(step, n: int, device) -> Dict:
    """Three windows of n steps each.  The first is not profiled: its
    length by the host clock, synchronized at both ends, is the time the n
    steps take as in an untraced run (the profiler slows the host), the
    denominator of the rate-based readings.  The second records the device
    alone, after the profiler's own warm-up: its busy seconds, and its
    length.  The third records the host too, with the benchmark's ranges,
    for the readers that attribute device time to layers."""
    from torch.profiler import ProfilerActivity, profile, schedule

    tmp = tempfile.gettempdir()
    paths = [os.path.join(tmp, f"portbench_{os.getpid()}_{k}.json")
             for k in ("timeline", "ranges")]
    cuda = torch.device(device).type == "cuda"
    _sync(device)
    start = time.perf_counter()
    for i in range(n):
        step(i)
    _sync(device)
    plain = time.perf_counter() - start
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    first = TRACE_WAIT + TRACE_WARMUP
    with profile(activities=acts,
                 schedule=schedule(wait=TRACE_WAIT, warmup=TRACE_WARMUP,
                                   active=n),
                 on_trace_ready=lambda p: p.export_chrome_trace(
                     paths[0])) as prof:
        for i in range(first + n):
            if i == first:
                _sync(device)
                start = time.perf_counter()
            step(n + i)
            if i == first + n - 1:
                _sync(device)
                window = time.perf_counter() - start
            prof.step()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts, schedule=schedule(wait=0, warmup=1,
                                                    active=n),
                 on_trace_ready=lambda p: p.export_chrome_trace(
                     paths[1])) as prof:
        for i in range(1 + n):
            step(first + 2 * n + i)
            prof.step()
    return {"timeline_path": paths[0], "trace_path": paths[1],
            "window_s": window, "plain_window_s": plain, "steps_traced": n,
            "steps_run": first + 3 * n + 1}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device) -> int:
    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def _rgb_hw(shape, mix):
    h, w = shape[1], shape[2]
    return (2 * h, 2 * w) if mix.get("s2d") else (h, w)


def _judge(records, cell, seed, device):
    """The worst reading of each compared number over the sampled batches;
    None when no sampled batch completed."""
    if not records:
        return None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    W = make_weights(param_shapes(cell.cfg), seed, device)
    per = [judge.judge_serve(W, cell.cfg, {**r, **r["batch"]})
           for r in records]
    return judge.worst(per)
