#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (ait_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout, one GPU

1. Prints the card, its power limit, the CUDA version, and builds every
   kernel of the eval path from ait_tpu_torch/csrc (one nvcc per source, in
   parallel).
2. Holds each kernel against its plain PyTorch version at the shapes the
   flagship eval path gives it at a batch of 8: float32 with TF32 off
   (max abs error <= 2e-3, the JAX package's TPU kernel gate), bfloat16 at
   the tolerance stated beside each check, NMS selections bit-equal; and
   times both (CUDA events, after warm-up).
3. Serves the full-width ResNet-50 flagship (random weights from a numpy
   seed, carried in through the weight bridge) with OneShotPredictor:
   batches of 8 uint8 608x800 canvases and 128x128 queries.  Every kernel's
   launch count is set to 0 just before and read just after; each must show
   its expected launches per forward.  The outputs must be finite and
   well-formed, and the kernel path must agree with the same model run
   through the plain versions (float32, batch 2).
4. Prints the per-kernel JSON line, then the device JSON line last.

Exits non-zero, with no result line, without a CUDA device or outside a
checkout of the repository.  Imports nothing of JAX or ait_tpu.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

B = 8                     # requests per batch
BATCHES = 3               # timed batches after one warm-up
HBM_BYTES_S = 3.35e12     # H100 SXM, published
BF16_FLOP_S = 989e12      # dense tensor cores
F32_FLOP_S = 67e12        # CUDA cores
F32_TOL = 2e-3            # tools/tpu_kernel_check.py's forward bound


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
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


def err_of(got, want):
    """float32: max abs error; bfloat16: max abs error over max(1, |want|),
    i.e. in units of a unit value's rounding (2^-8 is one bf16 ulp of a value
    in [1, 2))."""
    import torch

    diff = (got.float() - want.float()).abs()
    if got.dtype == want.dtype == torch.bfloat16:
        diff = diff / want.float().abs().clamp(min=1.0)
    return diff.max().item()


def bound(nbytes: float, flops: float, peak: float):
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- kernels


def check_nms(torch, dev):
    from ait_tpu_torch.ops import nms as nms_mod

    g = torch.Generator(device="cpu").manual_seed(1)
    entries = []
    # proposal layer (6000 -> tile-aligned 6144, thr 0.7) and postprocess
    # (300 detections, thr 0.3); both keep at most 300
    for n, thr in ((6144, 0.7), (300, 0.3)):
        ctr = torch.rand(B, n, 2, generator=g) * torch.tensor([800., 608.])
        wh = 16 + torch.rand(B, n, 2, generator=g) * 300
        boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], -1).clamp(0, 799)
        scores = torch.rand(B, n, generator=g)
        order = scores.argsort(dim=1, descending=True)
        boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
        valid = torch.ones(B, n, dtype=torch.bool)
        valid[::2, -n // 10:] = False        # padded rows on half the images
        boxes, valid = boxes.to(dev).contiguous(), valid.to(dev)
        cap = 300

        got = nms_mod.nms_keep_mask_batched(boxes, valid, thr, max_out=cap)
        want = nms_mod.nms_keep_mask_reference(boxes, valid, thr,
                                               max_out=cap)
        sel_got, cnt_got = nms_mod._select_top(got, cap)
        sel_want, cnt_want = nms_mod._select_top(want, cap)
        if not (torch.equal(cnt_got, cnt_want) and all(
                torch.equal(sel_got[i, :int(cnt_got[i])],
                            sel_want[i, :int(cnt_want[i])])
                for i in range(B))):
            fail(f"nms [{B},{n}] thr {thr}: kernel selections differ from "
                 "the plain version")
        ms = cuda_ms(lambda: nms_mod.nms_keep_mask_batched(
            boxes, valid, thr, max_out=cap), iters=20)
        plain_ms = cuda_ms(lambda: nms_mod.nms_keep_mask_reference(
            boxes, valid, thr, max_out=cap), iters=2, warmup=1)
        # IoU tests this data needs: each processed tile against the
        # survivors so far, plus its own upper triangle; ~25 f32 ops each
        kept = got.cpu()
        tests = 0
        for i in range(B):
            before = 0
            for start in range(0, n, 256):
                if before >= cap:
                    break
                tests += 256 * min(before, 384) + 256 * 255 // 2
                before += int(kept[i, start:start + 256].sum())
        t_bound, by = bound(B * n * (16 + 1 + 1), tests * 25, F32_FLOP_S)
        log(f"nms [{B},{n}] thr {thr}: selections bit-equal "
            f"(counts {cnt_got.tolist()}); kernel_ms {ms:.4f} "
            f"plain_ms {plain_ms:.3f} bound_ms {t_bound:.6f} ({by})")
        entries.append((ms, plain_ms, t_bound, by))
    return {"max_abs_err": 0.0, "ms": sum(e[0] for e in entries),
            "plain_ms": sum(e[1] for e in entries),
            "bound_ms": sum(e[2] for e in entries),
            "bound_by": entries[0][3]}


def _attn_args(torch, dev, p, tq, tk, dtype, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    d, h, dk = 512, 8, 64

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    xq = rn(p, tq, d)
    xkv = xq if tq == tk else rn(p, tk, d)
    ws = [rn(d, h * dk, scale=d ** -0.5) for _ in range(3)]
    args = [xq, xkv] + ws + [rn(dk, h * dk, scale=dk ** -0.5),
                             rn(h * dk, scale=0.05),
                             rn(dk, d, scale=dk ** -0.5)]
    args = [a.to(dtype) for a in args]
    ln = [(1 + 0.1 * torch.randn(d, generator=g)).to(dev),
          (0.1 * torch.randn(d, generator=g)).to(dev)]
    return args + ln


def check_attention(torch, dev):
    from ait_tpu_torch.ops.fused_attention import (fused_sh_attention,
                                                   sh_attention_reference)

    tok = torch.arange(64, device=dev)
    pad56 = (tok[:56] < 49)[None, :].expand(56, 56).contiguous()
    causal = torch.tril(torch.ones(64, 64, dtype=torch.bool, device=dev))
    cross = (tok[:56] < 49)[None, :].expand(64, 56).contiguous()
    # (name, pairs, Tq, Tk, mask, self-attention) at a batch of 8 requests
    calls = [("encoder self", 300 * B, 56, 56, pad56, True),
             ("decoder self", B, 64, 64, causal, True),
             ("decoder cross", 300 * B, 64, 56, cross, False)]
    errs, ms_sum, plain_sum, bound_sum = [], 0.0, 0.0, 0.0
    for name, p, tq, tk, mask, self_attn in calls:
        for dtype, tol in ((torch.float32, F32_TOL),
                           # bf16: the plain version rounds q/k/v, P, o_h and
                           # the gated sum to bf16 where the kernel keeps f32
                           # (as the Pallas kernel does): up to 4 bf16 ulps
                           (torch.bfloat16, 2.0 ** -5)):
            args = _attn_args(torch, dev, p, tq, tk, dtype, seed=tq + tk)
            got = fused_sh_attention(*args, mask)
            want = sh_attention_reference(*args, mask)
            err = err_of(got, want)
            if not math.isfinite(err) or err > tol:
                fail(f"sh_attention {name} {dtype}: err {err} > {tol}")
            if dtype == torch.float32:
                errs.append(err)
            log(f"sh_attention {name} P={p} {tq}x{tk} {dtype}: "
                f"err {err:.3e} (tol {tol})")
        ms = cuda_ms(lambda: fused_sh_attention(*args, mask))
        plain_ms = cuda_ms(lambda: sh_attention_reference(*args, mask))
        d, dk, h = 512, 64, 8
        flops = p * (2 * tq * d * h * dk + 2 * 2 * tk * d * h * dk +
                     h * 2 * 2 * tq * tk * dk + 2 * dk * h * dk +
                     2 * tq * dk * d)
        act = p * (tq if self_attn else tq + tk) * d * 2
        nbytes = (act + (3 * d * d + dk * h * dk + h * dk + dk * d) * 2 +
                  2 * d * 4 + tq * tk + p * tq * d * 2)
        t_bound, by = bound(nbytes, flops, BF16_FLOP_S)
        log(f"sh_attention {name}: kernel_ms {ms:.3f} plain_ms "
            f"{plain_ms:.3f} bound_ms {t_bound:.4f} ({by})")
        ms_sum, plain_sum, bound_sum = (ms_sum + ms, plain_sum + plain_ms,
                                        bound_sum + t_bound)
    return {"max_abs_err": max(errs), "ms": ms_sum, "plain_ms": plain_sum,
            "bound_ms": bound_sum, "bound_by": "operations"}


def check_ffn(torch, dev):
    from ait_tpu_torch.ops.fused_ffn import ffn_reference, fused_ffn

    g = torch.Generator(device="cpu").manual_seed(3)
    d, hid = 512, 2048
    errs, ms_sum, plain_sum, bound_sum = [], 0.0, 0.0, 0.0
    # encoder rows 300 * 8 * 56, decoder rows 300 * 8 * 64
    for name, n in (("encoder", 300 * B * 56), ("decoder", 300 * B * 64)):
        base = [torch.randn(n, d, generator=g),
                torch.randn(d, hid, generator=g) * d ** -0.5,
                0.05 * torch.randn(hid, generator=g),
                torch.randn(hid, d, generator=g) * hid ** -0.5,
                0.05 * torch.randn(d, generator=g),
                1 + 0.1 * torch.randn(d, generator=g),
                0.1 * torch.randn(d, generator=g)]
        base = [t.to(dev) for t in base]
        # bf16: the kernel and the plain version both round the hidden
        # activation to bf16 and sum in f32, in another order: a rounding may
        # flip, so up to 2 bf16 ulps
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, 2.0 ** -6)):
            args = [base[0].to(dtype), base[1].to(dtype), base[2],
                    base[3].to(dtype), base[4], base[5], base[6]]
            got = fused_ffn(*args)
            want = ffn_reference(*args)
            err = err_of(got, want)
            if not math.isfinite(err) or err > tol:
                fail(f"ffn {name} {dtype}: err {err} > {tol}")
            if dtype == torch.float32:
                errs.append(err)
            log(f"ffn {name} N={n} {dtype}: err {err:.3e} "
                f"(tol {tol})")
        ms = cuda_ms(lambda: fused_ffn(*args), iters=5)
        plain_ms = cuda_ms(lambda: ffn_reference(*args), iters=5)
        t_bound, by = bound(n * d * 2 * 2 + 2 * d * hid * 2 + (hid + 3 * d) * 4,
                            4 * n * d * hid, BF16_FLOP_S)
        log(f"ffn {name}: kernel_ms {ms:.3f} plain_ms {plain_ms:.3f} "
            f"bound_ms {t_bound:.4f} ({by})")
        ms_sum, plain_sum, bound_sum = (ms_sum + ms, plain_sum + plain_ms,
                                        bound_sum + t_bound)
    return {"max_abs_err": max(errs), "ms": ms_sum, "plain_ms": plain_sum,
            "bound_ms": bound_sum, "bound_by": "operations"}


def check_posln(torch, dev):
    from ait_tpu_torch.models.layers import sinusoid_table
    from ait_tpu_torch.ops.fused_ffn import fused_posln, posln_reference

    g = torch.Generator(device="cpu").manual_seed(4)
    d = 512
    errs, ms_sum, plain_sum, bound_sum = [], 0.0, 0.0, 0.0
    for name, n, t in (("encoder", 300 * B * 56, 56), ("decoder", B * 64, 64)):
        x = torch.randn(n, d, generator=g).to(dev)
        pos = torch.from_numpy(sinusoid_table(64, d)[:t]).to(dev)
        ln_s = (1 + 0.1 * torch.randn(d, generator=g)).to(dev)
        ln_b = (0.1 * torch.randn(d, generator=g)).to(dev)
        # bf16: the same f32 math inside both, sums in another order: the
        # final rounding may flip, so up to 2 bf16 ulps
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, 2.0 ** -6)):
            args = (x.to(dtype), pos.to(dtype), ln_s, ln_b)
            got = fused_posln(*args)
            want = posln_reference(*args)
            err = err_of(got, want)
            if not math.isfinite(err) or err > tol:
                fail(f"posln {name} {dtype}: err {err} > {tol}")
            if dtype == torch.float32:
                errs.append(err)
            log(f"posln {name} N={n} {dtype}: err {err:.3e} "
                f"(tol {tol})")
        ms = cuda_ms(lambda: fused_posln(*args), iters=20)
        plain_ms = cuda_ms(lambda: posln_reference(*args), iters=20)
        t_bound, by = bound(n * d * 2 * 2 + t * d * 2 + 2 * d * 4,
                            8 * n * d, BF16_FLOP_S)
        log(f"posln {name}: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
            f"bound_ms {t_bound:.4f} ({by})")
        ms_sum, plain_sum, bound_sum = (ms_sum + ms, plain_sum + plain_ms,
                                        bound_sum + t_bound)
    return {"max_abs_err": max(errs), "ms": ms_sum, "plain_ms": plain_sum,
            "bound_ms": bound_sum, "bound_by": "bytes"}


# ------------------------------------------------------------------ slice


@contextlib.contextmanager
def plain_path():
    """Route the model's kernel call sites to the plain versions (to hold
    the whole kernel path against the plain path on the same card)."""
    from ait_tpu_torch.models import ait_transformer, attention
    from ait_tpu_torch.ops import fused_attention, fused_ffn, nms

    swaps = [(attention, "fused_sh_attention",
              fused_attention.sh_attention_reference),
             (attention, "fused_ffn", fused_ffn.ffn_reference),
             (ait_transformer, "fused_posln", fused_ffn.posln_reference),
             (nms, "nms_keep_mask_batched", nms.nms_keep_mask_reference)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    for m, n, f in swaps:
        setattr(m, n, f)
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def make_requests(np, cfg, rng, b):
    h, w = cfg.tpu.image_size
    q = cfg.TRAIN.query_size
    canvas = np.zeros((b, h, w, 3), np.uint8)
    im_info = np.zeros((b, 3), np.float32)
    for i in range(b):
        # an image resized to the 600 scale, placed top-left on the canvas
        ih, iw = 600, int(rng.randint(450, w + 1))
        canvas[i, :ih, :iw] = rng.randint(0, 256, (ih, iw, 3))
        im_info[i] = (ih, iw, 600.0 / 375.0)
    query = rng.randint(0, 256, (b, q, q, 3)).astype(np.uint8)
    return canvas, query, im_info


def drive_slice(torch, np, dev):
    from ait_tpu_torch import bridge
    from ait_tpu_torch.config import Config
    from ait_tpu_torch.models import AITDetector
    from ait_tpu_torch.ops import fused_attention, fused_ffn, nms
    from ait_tpu_torch.predict import OneShotPredictor

    cfg = Config()
    t0 = time.time()
    shapes = bridge.jax_shapes(AITDetector(cfg))
    params = bridge.random_tree(shapes, seed=0)
    state = bridge.to_state_dict(AITDetector(cfg), params)
    n_params = sum(v.numel() for v in state.values())
    log(f"weights: {n_params} parameters from seed 0 through the bridge "
        f"({time.time() - t0:.1f} s)")
    predictor = OneShotPredictor(cfg, state, device=dev)
    rng = np.random.RandomState(0)
    requests = [make_requests(np, cfg, rng, B) for _ in range(BATCHES + 1)]

    kernels = {"nms_keep_mask": nms.nms_keep_mask_batched,
               "sh_attention_fwd": fused_attention.fused_sh_attention,
               "ffn_fwd": fused_ffn.fused_ffn,
               "posln_fwd": fused_ffn.fused_posln}
    for fn in kernels.values():
        fn.launches = 0
    times = []
    for i, req in enumerate(requests):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dets = predictor.predict_prepared(*req)
        torch.cuda.synchronize()
        if i:                                   # the first is the warm-up
            times.append((time.perf_counter() - t0) * 1e3)
        check_dets(np, dets, req[2], cfg)
    launches = {k: fn.launches for k, fn in kernels.items()}
    per_forward = {"nms_keep_mask": 2, "sh_attention_fwd": 3, "ffn_fwd": 2,
                   "posln_fwd": 2}
    for k, n in per_forward.items():
        if launches[k] != n * len(requests):
            fail(f"{k}: {launches[k]} launches over {len(requests)} "
                 f"forwards, expected {n} per forward")
    log(f"slice: {len(requests)} batches of {B} requests at "
        f"{cfg.tpu.image_size[0]}x{cfg.tpu.image_size[1]}; launches "
        f"{launches}")
    log(f"slice: ms per batch of {B} (after one warm-up): "
        f"{[round(t, 3) for t in times]}, mean {sum(times) / len(times):.3f}")
    compare_paths(torch, np, cfg, state, dev, requests[0])
    return launches, times


def check_dets(np, dets, im_info, cfg):
    if len(dets) != B:
        fail(f"{len(dets)} detection lists for {B} requests")
    for d, info in zip(dets, im_info):
        if d.ndim != 2 or d.shape[1] != 5 or \
                d.shape[0] > cfg.TEST.RPN_POST_NMS_TOP_N:
            fail(f"detections of shape {d.shape}")
        if not np.isfinite(d).all():
            fail("non-finite detections")
        h, w = info[0] / info[2], info[1] / info[2]
        x1, y1, x2, y2, s = d.T
        if not ((x1 <= x2).all() and (y1 <= y2).all() and (x1 >= 0).all()
                and (y1 >= 0).all() and (x2 <= w).all() and (y2 <= h).all()
                and (s > 0).all() and (s <= 1).all()
                and (np.diff(s) <= 0).all()):
            fail("malformed detections (box order, bounds, or score order)")


def compare_paths(torch, np, cfg, state, dev, req):
    """The kernel path against the plain path, float32, TF32 off, 2 pairs."""
    from ait_tpu_torch.models import AITDetector

    model = AITDetector(cfg, dtype=torch.float32)
    model.load_state_dict(state)
    model.to(dev).eval()
    image, query, im_info = (torch.from_numpy(a[:2]).to(dev) for a in req)
    with torch.inference_mode():
        got = model(image, query, im_info)
        with plain_path():
            want = model(image, query, im_info)
    torch.cuda.synchronize()
    diffs = {k: (getattr(got, k) - getattr(want, k)).abs().max().item()
             for k in ("rois", "cls_prob", "bbox_pred")}
    # upstream of the proposal layer both runs are the same ops, and the NMS
    # kernel bit-equals its plain version: identical rois; downstream the
    # f32 kernels (<= 2e-3 each, ~1e-5 measured) feed SKNet, layer4 and the
    # heads, which may amplify by a few times
    tol = {"rois": 0.0, "cls_prob": 1e-2, "bbox_pred": 1e-2}
    log(f"kernel path vs plain path (f32, 2 pairs): max abs diffs {diffs}")
    for k, v in diffs.items():
        if not math.isfinite(v) or v > tol[k]:
            fail(f"kernel path disagrees with the plain path on {k}: "
                 f"{v} > {tol[k]}")


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "ait_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(ait_tpu_torch/ not found beside this script)",
              file=sys.stderr)
        return 2
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from ait_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.time()
    sources = ["nms", "sh_attention", "ffn", "posln"]
    _build.build_all(sources)
    log(f"built {sources} in {time.time() - t0:.1f} s")

    results = {"nms_keep_mask": check_nms(torch, dev),
               "sh_attention_fwd": check_attention(torch, dev),
               "ffn_fwd": check_ffn(torch, dev),
               "posln_fwd": check_posln(torch, dev)}
    launches, _ = drive_slice(torch, np, dev)

    meta = {"nms_keep_mask": ("ait_tpu_torch/csrc/nms.cu",
                              "ait_tpu/ops/nms_pallas.py:133"),
            "sh_attention_fwd": ("ait_tpu_torch/csrc/sh_attention.cu",
                                 "ait_tpu/ops/pallas_attention.py:746"),
            "ffn_fwd": ("ait_tpu_torch/csrc/ffn.cu",
                        "ait_tpu/ops/pallas_ffn.py:195"),
            "posln_fwd": ("ait_tpu_torch/csrc/posln.cu",
                          "ait_tpu/ops/pallas_ffn.py:355")}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **results[name], "library_ms": None}
        for name, (src, rep) in meta.items()]}
    log(smi)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
