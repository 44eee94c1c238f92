#!/usr/bin/env python3
"""Where the time of the PyTorch port's eval slice or train step goes, on one
GPU.

    python3 tools/port_profile.py [--train [--t-dropout P]] [--long-seq]
                                  [--save-qkv] [--fwd-kernels]
                                  [--repo DIR] [--out FILE.json]

Builds the full-width ResNet-50 flagship (random weights from a numpy seed
through ait_tpu_torch.bridge).  By default it serves it with
OneShotPredictor on uint8 608x800 canvases; with --train it trains it
instead (`Config()` unchanged, model.t_dropout 0.1, bf16 compute,
make_train_step on batches of 8 with a few ground-truth boxes each;
--t-dropout trains it at another dropout rate, e.g. 0 for the kernels'
keep-1 forms).  --long-seq and --save-qkv turn on the port's two opt-in
kernel policies by setting their module switches
(ait_tpu_torch.models.attention._LONG_SEQ_FUSION: the co-attention's two
attentions on the fused long-sequence kernels;
ait_tpu_torch.ops.fused_attention._SAVE_QKV: the train forward saves q/k/v),
so the stage table shows the co-attention's time both ways.  Then it
reports, as JSON lines on stdout (and in --out):

* `stages` (eval only): device time per stage of the forward (CUDA events
  around the detector's submodules and its proposal layer and ROI Align
  calls), and postprocess, in ms per batch;
* `kernels`: the device kernels with the most time per batch or step
  (torch.profiler over two of them), and the device's busy share: their
  summed time over the mean wall clock of an unprofiled batch or step;
* `gemm_products`: the device time and launches of csrc/gemm.cu's
  products (tensor-core and FMA tiles and their split-K sums);
* `posln_kernels`: the device time and launches of csrc/posln.cu's
  kernels by template instance (`posln_kernel`, the glue's forward;
  `ln_bwd_kernel`, the LayerNorm backward of the glue and of the FFN;
  `ln_param_reduce_kernel`, its fixed-order parameter sums), and their
  sum;
* `batch_ms`: host wall clock per batch or step, ending in a synchronize;
* `peak_memory_gib`: the most device memory allocated during the timed
  batches or steps;
* with --fwd-kernels, first `fwd_kernels`: ms per call (CUDA events, after
  warm-up, bf16) of the attention and FFN forward wrappers at the eval
  shapes (300 rois per image) and the train shapes (128 rois per image,
  dropout from a seed, the attention's saved-outputs form), summed per eval
  forward or train step.

--repo DIR profiles the ait_tpu_torch of another checkout (e.g. a `git
archive` of an earlier commit) with this script's measurements, so that two
versions can be compared in one call on one card.

Imports nothing of JAX or ait_tpu.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# csrc/posln.cu's kernels (the last one since its redesign)
POSLN_KERNELS = ("posln_kernel", "ln_bwd_kernel", "ln_param_reduce_kernel")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--train", action="store_true",
                    help="profile the train step instead of the eval slice")
    ap.add_argument("--t-dropout", type=float, default=None,
                    help="train at this model.t_dropout (default: the "
                    "config's, 0.1)")
    ap.add_argument("--long-seq", action="store_true",
                    help="fuse the co-attention's long-sequence attentions "
                    "(sets models.attention._LONG_SEQ_FUSION)")
    ap.add_argument("--save-qkv", action="store_true",
                    help="save q/k/v in the train forward for the backward "
                    "(sets ops.fused_attention._SAVE_QKV)")
    ap.add_argument("--fwd-kernels", action="store_true",
                    help="also time the attention and FFN forward kernels "
                    "at the eval and train shapes")
    ap.add_argument("--repo", default=REPO,
                    help="the checkout whose ait_tpu_torch to profile")
    ap.add_argument("--out", help="also write the full result here")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))
    bs, batches = 8, 5

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("port_profile: no CUDA device", file=sys.stderr)
        return 2
    from ait_tpu_torch import bridge
    from ait_tpu_torch.config import Config
    from ait_tpu_torch.models import AITDetector
    from ait_tpu_torch.models import attention as attention_mod
    from ait_tpu_torch.models import detector as det_mod
    from ait_tpu_torch.ops import fused_attention
    from ait_tpu_torch import predict as predict_mod
    from ait_tpu_torch.predict import OneShotPredictor

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    fwd = _time_fwd_kernels(bs) if args.fwd_kernels else None
    if fwd is not None:
        print(json.dumps({"fwd_kernels": fwd}), flush=True)
    attention_mod._LONG_SEQ_FUSION = args.long_seq
    fused_attention._SAVE_QKV = args.save_qkv
    cfg = Config()
    model = AITDetector(cfg)
    state = bridge.to_state_dict(model, bridge.random_tree(
        bridge.jax_shapes(model), seed=0))

    rng = np.random.RandomState(0)
    h, w = cfg.tpu.image_size
    q = cfg.TRAIN.query_size

    # the padding users send, predict.CANVAS_FILL, from the normalize's mean
    # (which a checkout from before that constant has too)
    fill = [round(m * 255.0) for m in det_mod._NORM_MEAN]

    def request():
        canvas = np.empty((bs, h, w, 3), np.uint8)
        canvas[:] = fill
        canvas[:, :600, :760] = rng.randint(0, 256, (bs, 600, 760, 3))
        query = rng.randint(0, 256, (bs, q, q, 3)).astype(np.uint8)
        info = np.tile(np.asarray([[600, 760, 1.6]], np.float32),
                       (bs, 1))
        return canvas, query, info

    events = collections.defaultdict(list)
    if args.train:
        run = _train_runner(cfg, state, request, rng, args.t_dropout)
    else:
        pred = OneShotPredictor(cfg, state)
        m = pred.model

        # ---- stage times: CUDA events around each stage -------------------
        def timed(name, fn):
            def call(*a, **k):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*a, **k)
                end.record()
                events[name].append((start, end))
                return out
            return call

        for name in ("backbone", "coattention", "rpn", "transformer", "sk",
                     "top", "cls_score_0", "cls_score_1", "bbox_pred_head"):
            mod = getattr(m, name)
            mod.forward = timed(name, mod.forward)
        det_mod.proposal_layer = timed("proposal_layer",
                                       det_mod.proposal_layer)
        det_mod.roi_align = timed("roi_align", det_mod.roi_align)
        predict_mod.postprocess_detections = timed(
            "postprocess", predict_mod.postprocess_detections)

        def run(r):
            pred.predict_prepared(*r)

    reqs = [request() for _ in range(batches + 2)]
    for r in reqs[:2]:                              # warm-up
        run(r)
    torch.cuda.synchronize()
    events.clear()
    torch.cuda.reset_peak_memory_stats()
    batch_ms = []
    for r in reqs[2:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(r)
        torch.cuda.synchronize()
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    stages = {k: sum(s.elapsed_time(e) for s, e in v) / batches
              for k, v in events.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    # ---- kernels and busy share: torch.profiler over two batches ---------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        for r in reqs[:2]:
            run(r)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        # device-side entries only (kernels, copies); the host ops that
        # launched them carry the same time again
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", 0.0)
        if dev_us > 0:
            rows.append((e.key, dev_us / 2e3, e.count // 2))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    # csrc/gemm.cu's products (tensor-core and FMA tiles, split-K sums)
    products = [r for r in rows
                if "gemm_kernel" in r[0] or "reduce_splits" in r[0]]
    # csrc/posln.cu's kernels by template instance (e.g. the glue's
    # ln_bwd_kernel<bf16, bf16, bf16, ..> apart from the FFN's <bf16, float,
    # float, ..>)
    posln = {}
    for key, ms, n in rows:
        for name in POSLN_KERNELS:
            if name + "<" in key or name + "(" in key:
                inst = key[key.index(name):].split("(")[0]
                ms0, n0 = posln.get(inst, (0.0, 0))
                posln[inst] = (ms0 + ms, n0 + n)
    mean_ms = sum(batch_ms) / len(batch_ms)
    result = {
        "card": card, "repo": os.path.abspath(args.repo),
        "path": "train" if args.train else "eval", "bs": bs,
        "long_seq": args.long_seq, "save_qkv": args.save_qkv,
        "t_dropout": (cfg.model.t_dropout if args.t_dropout is None
                      else args.t_dropout) if args.train else None,
        "batches": batches,
        "batch_ms": batch_ms,
        "peak_memory_gib": peak_gib,
        "fwd_kernels": fwd,
        "stages_ms_per_batch": stages,
        "device_busy_ms_per_batch": busy_ms,
        "device_busy_share": busy_ms / mean_ms,
        "gemm_products_ms_per_batch": sum(r[1] for r in products),
        "gemm_products_calls_per_batch": sum(r[2] for r in products),
        "posln_kernels_ms_per_batch": sum(v[0] for v in posln.values()),
        "posln_kernels": {k: {"ms": v[0], "calls": v[1]}
                          for k, v in posln.items()},
        "top_kernels_ms_per_batch": [
            {"name": k[:120], "ms": ms, "calls": n} for k, ms, n in rows[:25]],
    }
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({"path": result["path"], "t_dropout": result["t_dropout"],
                      "repo": result["repo"], "batch_ms": batch_ms,
                      "peak_memory_gib": peak_gib,
                      "device_busy_ms_per_batch": busy_ms,
                      "device_busy_share": result["device_busy_share"],
                      "gemm_products_ms_per_batch":
                          result["gemm_products_ms_per_batch"],
                      "gemm_products_calls_per_batch":
                          result["gemm_products_calls_per_batch"],
                      "posln_kernels_ms_per_batch":
                          result["posln_kernels_ms_per_batch"],
                      "posln_kernels": result["posln_kernels"]}))
    if stages:
        print(json.dumps({"stages_ms_per_batch": stages}))
    for r in result["top_kernels_ms_per_batch"]:
        print(json.dumps(r))
    return 0


def _time_fwd_kernels(bs):
    """{name: ms per call per shape, and their sum} of the attention and
    FFN forward wrappers, bf16, random operands from a seed: the eval
    forward's calls (300 rois per image: the encoder's and the decoder's
    attentions, 56 x 56, 64 x 64 causal, 64 x 56; their FFNs) and the train
    step's (128 rois per image, dropout 0.1 from a seed)."""
    import torch

    from ait_tpu_torch.ops import fused_attention as fa, fused_ffn as ff

    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    bf = torch.bfloat16
    seed = torch.tensor([1, 2], dtype=torch.int32, device=dev)

    def rn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    def ms(fn, iters=10):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def attn_args(p, tq, tk):
        xq = rn(p, tq, 512)
        xkv = xq if tq == tk else rn(p, tk, 512)
        tok = torch.arange(tk, device=dev)
        mask = (torch.tril(torch.ones(tq, tk, dtype=torch.bool, device=dev))
                if tq == tk == 64 else (tok < 49)[None].expand(tq, tk))
        return ([xq, xkv] + [rn(512, 512, scale=512 ** -0.5)
                             for _ in range(3)] +
                [rn(64, 512, scale=0.125), rn(512, scale=0.05),
                 rn(64, 512, scale=0.125), 1 + rn(512, scale=0.1,
                                                  dtype=torch.float32),
                 rn(512, scale=0.1, dtype=torch.float32),
                 mask.contiguous()])

    def ffn_args(n):
        return [rn(n, 512), rn(512, 2048, scale=512 ** -0.5),
                rn(2048, scale=0.05, dtype=torch.float32),
                rn(2048, 512, scale=2048 ** -0.5),
                rn(512, scale=0.05, dtype=torch.float32),
                1 + rn(512, scale=0.1, dtype=torch.float32),
                rn(512, scale=0.1, dtype=torch.float32)]

    res = {}
    shapes = ((300 * bs, 56, 56), (bs, 64, 64), (300 * bs, 64, 56))
    res["attention_eval"] = [ms(lambda a=attn_args(*s): fa.fused_sh_attention(
        *a)) for s in shapes]
    shapes = ((128 * bs, 56, 56), (bs, 64, 64), (128 * bs, 64, 56))
    res["attention_train"] = [ms(lambda a=attn_args(*s): (
        fa.fused_sh_attention_saved(*a, seed=seed, keep_prob=0.9)))
        for s in shapes]
    res["ffn_eval"] = [ms(lambda a=ffn_args(n): ff.fused_ffn(*a), 5)
                       for n in (300 * bs * 56, 300 * bs * 64)]
    res["ffn_train"] = [ms(lambda a=ffn_args(n): ff.fused_ffn(
        *a, seed=seed, keep_prob=0.9), 5) for n in (128 * bs * 56,
                                                   128 * bs * 64)]
    for k in list(res):
        res[k + "_sum"] = sum(res[k])
    return res


def _train_runner(cfg, state, request, rng, t_dropout=None):
    """run(request) = one train step of the flagship as `Config()` trains
    it (dropout included, or at `t_dropout`), bf16, with 1-4 ground-truth
    boxes of class 1 per image."""
    import dataclasses

    import numpy as np
    import torch

    from ait_tpu_torch.models import AITDetector
    from ait_tpu_torch.train import (lr_schedule, make_optimizer,
                                     make_train_step)

    if t_dropout is not None:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    t_dropout=t_dropout))
    model = AITDetector(cfg, dtype=torch.bfloat16)
    model.load_state_dict(state)
    t = cfg.TRAIN
    step = make_train_step(model, make_optimizer(cfg, model), lr_schedule(
        t.LEARNING_RATE, 1000, 5, t.GAMMA))
    gen = torch.Generator(device="cuda").manual_seed(0)

    def run(req):
        canvas, query, info = req
        gt = np.zeros((len(canvas), cfg.MAX_NUM_GT_BOXES, 5), np.float32)
        for i in range(len(canvas)):
            ih, iw = info[i, :2]
            for j in range(rng.randint(1, 5)):
                bw, bh = rng.uniform(48, iw / 2), rng.uniform(48, ih / 2)
                x1 = rng.uniform(0, iw - bw - 1)
                y1 = rng.uniform(0, ih - bh - 1)
                gt[i, j] = (x1, y1, x1 + bw, y1 + bh, 1)
        step({"image": canvas, "query": query, "im_info": info,
              "gt_boxes": gt}, gen)

    return run


if __name__ == "__main__":
    sys.exit(main())
