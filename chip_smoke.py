#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (ait_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout, one GPU

1. Prints the card, its power limit, the CUDA version, and builds every
   kernel of the eval and train paths from ait_tpu_torch/csrc (one nvcc per
   source, in parallel).
2. Holds each kernel against its plain PyTorch version at the shapes the
   flagship gives it at a batch of 8, and times both (CUDA events, after
   warm-up):
   * eval path: float32 with TF32 off (max abs error <= 2e-3, the JAX
     package's TPU kernel gate), bfloat16 at the tolerance stated beside
     each check, NMS selections bit-equal;
   * train path (128 rois per image): the attention forward that saves its
     per-head outputs, and the attention, FFN and glue backward kernels,
     whose plain versions are torch autograd through the plain forwards.
     float32 with TF32 off: every cotangent within 5e-3 of its max
     |plain| (the backward gate of tools/tpu_kernel_check.py), the saved
     outputs within 2e-3 absolute; bfloat16 at the stated tolerance; NMS
     at the train tops (12032 candidates, cap 2000) bit-equal.
   * check_gemm: the product kernel (csrc/gemm.cu: the attention
     projections, the backward's products) at every shape of the default
     train step against `gemm_reference` (f32 outputs within 1e-4 of max
     |plain|, bf16 within 8e-3), split K bit-equal across two runs, HGMMA in
     the built library's SASS, per shape its time beside the plain
     version's, one PyTorch call's and the bound, summed per step; the
     FMA-tile products (f32 x f32) under 1 ms a step.
   * the two forwards on the tensor cores (csrc/ffn.cu, csrc/sh_attention.cu's
     core after the projections): HGMMA in their libraries, their kernels'
     registers and spills logged (cuobjdump's resource usage; the FFN's
     tensor-core kernel must not spill), and every mode
     (eval, saved outputs, dropout from a seed and from operand masks,
     save-qkv) at the eval and the train shapes against the plain versions;
     the attention's eval time also split into its projections and core.
   * the per-pair attention backward kernel alone (check_bwd_pairs,
     csrc/sh_attention.cu sh_attn_bwd_kernel) against its plain version on
     the same projections at the train shapes (f32 within 5e-6 and bf16
     within 2e-2 of each output's max |plain|; no dropout, the seed's
     stream, operand masks; the saved q/k/v bit-equal to the projections),
     its per-head split products alone within SPLIT_BOUND, and HMMA in the
     library's SASS; its time per step beside its own bound.
   * NMS on two inputs per call: the synthetic boxes and the flagship's own
     proposals (its anchors decoded with small seeded deltas), with the
     tiles walked and IoU tests logged; the kernel's time and bound are the
     proposals'.
   * the LayerNorm glue (csrc/posln.cu, persistent blocks): the forward
     and the backward at every main-path shape and mode, including the
     backward in the FFN's mode alone (check_ffn_ln_bwd: 57,344 and 65,536
     rows, f32 addend, dy and dy2), dln_s and dln_b bit-equal over two
     calls; their times on the device (torch.profiler: the event time of a
     512-row call measures its wrapper's host work) beside the bound, the
     plain version's and a yardstick, one PyTorch LayerNorm call on the
     already-summed rows (`F.layer_norm` forward, aten's
     native_layer_norm_backward); the library's registers logged.
   * Philox's bound term: one Philox4x32-10 call's instructions counted in
     the posln library's SASS, at the int32 issue rate (64 a clock per SM
     on compute capability 9.0) x the SMs x nvidia-smi's SM clock.
   * the tiled attention (csrc/sh_attention_general.cu, check_attention_
     general) at the co-attention's two shapes and two 65-128 token shapes
     in every mode against the plain versions; at the co-attention's
     shapes two calls of every mode bit-equal (its sums across blocks are
     in a fixed order), each call's kernels timed on the device by name
     beside the wrappers' event times; HMMA in the library's SASS, its
     kernels' registers and spills logged.  The mask dump's time at the
     co-attention's 4 dumps is a device time too.
3. Serves the full-width ResNet-50 flagship (random weights from a numpy
   seed, carried in through the weight bridge) with OneShotPredictor:
   batches of 8 uint8 608x800 canvases and 128x128 queries.  Every kernel's
   launch count is set to 0 just before and read just after; each must show
   its expected launches per forward.  The outputs must be finite and
   well-formed, and the kernel path must agree with the same model run
   through the plain versions (float32, batch 2).
   * dropout (keep_prob 0.9, the train path's default): the mask dump
     kernel at the B=8 train shapes bit-equal to the plain Philox stream
     (ops/philox.py), two launches bit-equal, the keep rate of every dump
     within 0.01 of 0.9, a pair's masks the same from a dump of 4 pairs as
     from one of 1024; then the dropout forms of the attention (masks from a
     seed, and from operand masks), FFN and glue kernels, forward and
     backward, each against its plain version fed the dumped masks, at the
     tolerances above.
4. Trains the same flagship, `Config()` unchanged (model.t_dropout 0.1,
   bfloat16 compute, float32 parameters), with make_train_step: one warm-up
   and 3 timed steps on batches of 8 with a few ground-truth boxes each.
   The launch counts are set to 0 before and read after; each kernel must
   show its launches per step (csrc/gemm.cu's products: 33 on the tensor
   cores and 3 on the FMA tiles).  The five losses must be finite, every
   trainable leaf must move and every frozen leaf and buffer must stay
   bitwise unchanged; and one float32 train step at batch 2 must agree with
   the plain path on the same weights and draws, dropout masks included
   (losses within 1e-4 relative, every gradient within 5e-3 of its leaf's
   max |plain|).  Then the same at model.t_dropout = 0, shorter (one
   warm-up, one timed step, the f32 comparison), so that the kernels'
   keep-1 forms keep their train launches.
5. The data path (`drive_data_path`): writes a VOC-layout devkit of 24
   images from a numpy seed (landscape 375x500, portrait 500x375, wide
   330x600; XML annotations and image sets, the pixels served by an
   `imread` over the seeded arrays), loads it with `load_voc` and
   `filter_seen`, and runs `OneShotLoader` with `Config()` unchanged (the
   608x800 canvas, its portrait transpose and the 608x1216 bucket, uint8,
   host space-to-depth) at B = 8 through `device_prefetch` into the
   flagship's eval step on the kernel path and `postprocess_detections`,
   then `evaluate_voc`.  Every batch must come on one of the three canvases
   as [8, 304, 400, 12], [8, 400, 304, 12] or [8, 304, 608, 12], show every
   kernel's launches per forward, arrive bit-equal to its host arrays and
   give finite detections inside each image; the ground truth as detections
   must score AP 1 in every class, the model's AP must be finite in [0, 1];
   the 12-plane stem must equal the 7x7/2 stem on the same canvas (f32, TF32
   off, within STEM_REL of max |3-plane|, the backbone's features within
   BACKBONE_REL) and the kernel path the plain path on a batch of 2 (as in
   3).  Then two train steps of `Config()` from `OneShotLoader(training=
   True)` through `device_prefetch`, each with its launches and finite
   losses.  Prints the host loader's ms a batch, the H2D ms a batch from
   pinned and from pageable memory, eval pairs/s end to end from the raw
   arrays, and the two stems' device ms.
6. Prints the per-kernel JSON line, then the device JSON line last.

Exits non-zero, with no result line, without a CUDA device or outside a
checkout of the repository.  Imports nothing of JAX or ait_tpu.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

B = 8                     # requests per batch (eval) and images per step
BATCHES = 3               # timed batches after one warm-up
STEPS = 3                 # timed train steps after one warm-up
ROIS = 128                # sampled rois per image (TRAIN.BATCH_SIZE)
HBM_BYTES_S = 3.35e12     # H100 SXM, published
BF16_FLOP_S = 989e12      # dense tensor cores
F32_FLOP_S = 67e12        # CUDA cores
F32_TOL = 2e-3            # tools/tpu_kernel_check.py's forward bound
BWD_REL = 5e-3            # its backward bound, relative to max |plain|
# bf16 backward, relative to max |plain|: the plain version rounds q/k/v,
# the probabilities, the per-head outputs and the hidden activation to bf16
# where the kernels keep f32 between products (as the Pallas kernels do);
# each rounding is 2^-9 relative and a cotangent passes through a few
# (measured <= 9.4e-3 at 64 pairs on an H100)
BF16_BWD_REL = 2e-2
# the same in the long-sequence regime: there dk, dv and their weight
# gradients sum over 1900 rows of probabilities that the plain version rounds
# to bf16 (the kernels keep f32), and dwv reaches 2.04e-2 at 8 pairs of
# 1900 x 64 on an H100; the bf16 kernel is also held to BF16_BWD_REL against
# the plain version run in f32 on the same bf16-rounded operands
BF16_BWD_REL_LONG = 4e-2
KEEP = 0.9                # 1 - Config().model.t_dropout
# int32 results per clock per SM on compute capability 9.0 (add, multiply
# and multiply-add, logic, compare: the CUDA C++ Programming Guide's
# arithmetic-throughput table; f32 add and FMA are 128).  Philox4x32-10 is
# integer work: its bound term is one `keep_group` call's instructions,
# counted in the built posln library's SASS (`philox_instructions`), over
# this rate times the SMs and the SM clock that nvidia-smi reports.
INT32_PER_CLOCK_SM = 64
# set by main(): instructions of one Philox call, the card's int32 rate
PHILOX = {"instructions": None, "int32_ops_s": None}
# profiles `device_kernels` takes before it fails for want of device records
PROFILE_ATTEMPTS = 3


def philox_s(groups):
    """Seconds of int32 issue that `groups` Philox4x32-10 calls need."""
    return groups * PHILOX["instructions"] / PHILOX["int32_ops_s"]


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


def device_kernels(fn, iters: int = 20, warmup: int = 2):
    """[(kernel, launches a call, device ms a call)] of the kernels that
    fn launches (torch.profiler over `iters` calls, after warm-up).  A
    profile that recorded no device kernel at all (the profiler now and
    then drops a window's device records) is taken again, up to
    `PROFILE_ATTEMPTS` times, then fails."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.count / iters,
                 e.self_device_time_total / iters / 1e3)
                for e in prof.key_averages()
                if getattr(e, "device_type", None) == DeviceType.CUDA and
                getattr(e, "self_device_time_total", 0.0) > 0]
        if rows:
            return rows
    fail(f"torch.profiler recorded no device kernel in {PROFILE_ATTEMPTS} "
         "profiles")


def device_ms(fn, iters: int = 20, warmup: int = 2) -> float:
    """Device time of one call of fn: the summed time of the kernels it
    launches.  Event timing (`cuda_ms`) of a call shorter than its
    wrapper's host work measures the host; this does not."""
    return sum(ms for _, _, ms in device_kernels(fn, iters, warmup))


def layer_norm_yardstick(torch, y, g=None):
    """Device ms of one PyTorch LayerNorm call on the already-summed rows y
    (eps 1e-6; weight and bias in y's dtype): `F.layer_norm`'s forward, or
    with the cotangent g its backward (aten's native_layer_norm_backward
    from the forward's mean and rstd).  A yardstick, not a library call
    for the same function: it omits the add and the dropout."""
    d = y.shape[1]
    w = torch.ones(d, dtype=y.dtype, device=y.device)
    b = torch.zeros(d, dtype=y.dtype, device=y.device)
    if g is None:
        return device_ms(lambda: torch.nn.functional.layer_norm(
            y, (d,), w, b, 1e-6))
    _, mean, rstd = torch.ops.aten.native_layer_norm(y, [d], w, b, 1e-6)
    return device_ms(lambda: torch.ops.aten.native_layer_norm_backward(
        g.to(y.dtype), y, [d], mean, rstd, w, b, [True, True, True]))


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


NMS_EVAL = ((6144, 0.7, 300), (300, 0.3, 300))
NMS_TRAIN = ((12032, 0.7, 2000),)
# the flagship's proposals: 9 anchors at each cell of the 38 x 50 feature map
# (608 x 800 canvas, stride 16) and the candidates each call keeps (the
# sweep takes them rounded up to its 256-box tile, the rest invalid)
FEAT_HW, FEAT_STRIDE = (38, 50), 16
NMS_TOP = {6144: 6000, 12032: 12000, 300: 300}


def synthetic_nms_boxes(torch, g, n):
    """B images of n score-sorted boxes, random centres over the canvas and
    sides of 16-316 px, drawn from the CPU generator g; valid [B, n] with
    the last tenth padded on every other image."""
    ctr = torch.rand(B, n, 2, generator=g) * torch.tensor([800., 608.])
    wh = 16 + torch.rand(B, n, 2, generator=g) * 300
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], -1).clamp(0, 799)
    scores = torch.rand(B, n, generator=g)
    order = scores.argsort(dim=1, descending=True)
    boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    valid = torch.ones(B, n, dtype=torch.bool)
    valid[::2, -n // 10:] = False        # padded rows on half the images
    return boxes.contiguous(), valid


def model_nms_boxes(torch, n, seed, images=B):
    """`images` images of n proposals as the flagship's proposal layer hands
    them to NMS: its 17,100 anchors (ops/anchors.py at the 38 x 50 map)
    decoded (ops/boxes.py) with deltas 0 (even images: an untrained head) or
    N(0, 0.05) (odd images), clipped to the 608 x 800 canvas, in the order
    of a seeded uniform score, the first n taken and those past the call's
    top-k (NMS_TOP) invalid.  Overlapping clusters, as a real RPN emits."""
    from ait_tpu_torch.ops import anchors, boxes as box_ops

    anc = torch.from_numpy(anchors.shifted_anchors(*FEAT_HW, FEAT_STRIDE))
    g = torch.Generator(device="cpu").manual_seed(seed)
    hw = torch.tensor([FEAT_HW[0] * FEAT_STRIDE, FEAT_HW[1] * FEAT_STRIDE],
                      dtype=torch.float32)
    out = []
    for i in range(images):
        deltas = torch.randn(anc.shape, generator=g) * 0.05
        if i % 2 == 0:
            deltas.zero_()
        props = box_ops.clip_boxes(box_ops.bbox_transform_inv(anc, deltas),
                                   hw)
        scores = torch.rand(anc.shape[0], generator=g)
        order = torch.sort(scores, descending=True, stable=True).indices
        out.append(props[order[:n]])
    valid = (torch.arange(n) < NMS_TOP.get(n, n))[None].expand(images, n)
    return torch.stack(out).contiguous(), valid.contiguous()


def nms_walk(keep, n, cap):
    """(tiles walked, IoU tests) of the sweep per image, from its keep bits
    [images, n]: each tile until the cap is reached, tested against the
    survivors so far (the kernel holds at most the cap rounded up to 128)
    and its own upper triangle."""
    cap_pad = -(-cap // 128) * 128
    kept = keep.cpu()
    tiles, tests = [], []
    for i in range(kept.shape[0]):
        before, walked, count = 0, 0, 0
        for start in range(0, n, 256):
            if before >= cap:
                break
            walked += 1
            count += 256 * min(before, cap_pad) + 256 * 255 // 2
            before += int(kept[i, start:start + 256].sum())
        tiles.append(walked)
        tests.append(count)
    return tiles, tests


def check_nms(torch, dev, shapes):
    """shapes: (candidates, threshold, survivor cap) per call.  Each call on
    two inputs: the synthetic boxes (`synthetic_nms_boxes`) and the
    flagship's own proposals (`model_nms_boxes`, what the model's calls
    sweep); the kernel's selections bit-equal to the plain version's on
    both.  ms, plain_ms and bound_ms sum the model's input over the
    calls."""
    from ait_tpu_torch.ops import nms as nms_mod

    g = torch.Generator(device="cpu").manual_seed(1)
    entries = []
    # eval: the proposal layer (6000 -> tile-aligned 6144, thr 0.7) and the
    # postprocess (300 detections, thr 0.3), both keep at most 300; train:
    # the proposal layer at the TRAIN tops (12000 -> 12032, keep 2000)
    for n, thr, cap in shapes:
        inputs = (("synthetic", synthetic_nms_boxes(torch, g, n)),
                  ("model", model_nms_boxes(torch, n, seed=n)))
        for what, (boxes, valid) in inputs:
            boxes, valid = boxes.to(dev), valid.to(dev)
            want = nms_mod.nms_keep_mask_reference(boxes, valid, thr,
                                                   max_out=cap)
            sel_want, cnt_want = nms_mod._select_top(want, cap)
            got = nms_mod.nms_keep_mask_batched(boxes, valid, thr,
                                                max_out=cap)
            sel_got, cnt_got = nms_mod._select_top(got, cap)
            if not (torch.equal(cnt_got, cnt_want) and all(
                    torch.equal(sel_got[i, :int(cnt_got[i])],
                                sel_want[i, :int(cnt_want[i])])
                    for i in range(B))):
                fail(f"nms [{B},{n}] thr {thr} cap {cap} ({what}): kernel "
                     "selections differ from the plain version")
            ms = cuda_ms(lambda: nms_mod.nms_keep_mask_batched(
                boxes, valid, thr, max_out=cap), iters=20)
            plain_ms = cuda_ms(lambda: nms_mod.nms_keep_mask_reference(
                boxes, valid, thr, max_out=cap), iters=2, warmup=1)
            # the IoU tests this data needs, ~25 f32 ops each
            tiles, tests = nms_walk(want, n, cap)
            t_bound, by = bound(B * n * (16 + 1 + 1), sum(tests) * 25,
                                F32_FLOP_S)
            log(f"nms [{B},{n}] thr {thr} cap {cap} {what}: selections "
                f"bit-equal (counts {cnt_want.tolist()}); tiles walked "
                f"{tiles}, IoU tests per image {tests}; kernel_ms {ms:.4f} "
                f"plain_ms {plain_ms:.3f} bound_ms {t_bound:.6f} ({by})")
            if what == "model":
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
    from ait_tpu_torch.ops import fused_attention as fa
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
    parts = [0.0, 0.0]                   # projections, core
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
        # the route's two parts: the projections on csrc/gemm.cu, then the
        # per-pair core of csrc/sh_attention.cu
        proj_ms = cuda_ms(lambda: fa.project(*args[:5]))
        proj = fa.project(*args[:5])
        core_ms = cuda_ms(lambda: fa.short_core(args[0], proj, *args[5:10],
                                                mask, tk))
        del proj
        d, dk, h = 512, 64, 8
        flops = p * (2 * tq * d * h * dk + 2 * 2 * tk * d * h * dk +
                     h * 2 * 2 * tq * tk * dk + 2 * dk * h * dk +
                     2 * tq * dk * d)
        act = p * (tq if self_attn else tq + tk) * d * 2
        nbytes = (act + (3 * d * d + dk * h * dk + h * dk + dk * d) * 2 +
                  2 * d * 4 + tq * tk + p * tq * d * 2)
        t_bound, by = bound(nbytes, flops, BF16_FLOP_S)
        log(f"sh_attention {name}: kernel_ms {ms:.3f} (projections "
            f"{proj_ms:.3f}, core {core_ms:.3f}) plain_ms {plain_ms:.3f} "
            f"bound_ms {t_bound:.4f} ({by})")
        ms_sum, plain_sum, bound_sum = (ms_sum + ms, plain_sum + plain_ms,
                                        bound_sum + t_bound)
        parts[0] += proj_ms
        parts[1] += core_ms
    return {"max_abs_err": max(errs), "ms": ms_sum, "plain_ms": plain_sum,
            "bound_ms": bound_sum, "bound_by": "operations",
            "projection_ms": parts[0], "core_ms": parts[1]}


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
    """The glue's forward (csrc/posln.cu `posln_kernel`) at the eval
    forward's two calls against its plain version; its device time
    (`device_ms`: the decoder's 512 rows take less device time than the
    wrapper's host work, which the event time logged beside it measures),
    the bound, the plain version's time and the F.layer_norm yardstick on
    the summed rows."""
    from ait_tpu_torch.models.layers import sinusoid_table
    from ait_tpu_torch.ops.fused_ffn import fused_posln, posln_reference

    g = torch.Generator(device="cpu").manual_seed(4)
    d = 512
    errs, sums = [], [0.0] * 4            # ms, plain, bound, yardstick
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
        ms = device_ms(lambda: fused_posln(*args))
        event_ms = cuda_ms(lambda: fused_posln(*args), iters=20)
        plain_ms = cuda_ms(lambda: posln_reference(*args), iters=20)
        yard = layer_norm_yardstick(torch, (args[0].float() + args[1].float(
        ).repeat(n // t, 1)).to(args[0].dtype))
        t_bound, by = bound(n * d * 2 * 2 + t * d * 2 + 2 * d * 4,
                            8 * n * d, F32_FLOP_S)
        log(f"posln {name}: kernel_ms {ms:.4f} (device; event {event_ms:.4f}) "
            f"plain_ms {plain_ms:.4f} bound_ms {t_bound:.4f} ({by}) "
            f"F.layer_norm yardstick_ms {yard:.4f}")
        sums = [a + b for a, b in zip(sums, (ms, plain_ms, t_bound, yard))]
    return {"max_abs_err": max(errs), "ms": sums[0], "plain_ms": sums[1],
            "bound_ms": sums[2], "bound_by": "bytes", "yardstick_ms": sums[3]}


# the eval path's attention calls at a batch of 8 requests, 300 rois each
ATTN_EVAL = (("encoder self", 300 * B, 56, 56, True),
             ("decoder self", B, 64, 64, True),
             ("decoder cross", 300 * B, 64, 56, False))


def check_forward_modes(torch, dev):
    """The redesigned forwards (csrc/sh_attention.cu's core after the
    projections, csrc/ffn.cu's tensor-core kernel) in the modes and at the
    shapes the other checks leave out, at their tolerances: the eval
    attention at the train shapes; its saved-outputs, dropout (from a seed,
    and from operand masks) and save-qkv forms at the eval shapes; the FFN
    at the train row counts, its dropout form at the eval ones.  Returns the
    float32 errors, by the JSON line's entry."""
    from ait_tpu_torch.ops import dropout_masks as dm
    from ait_tpu_torch.ops import fused_attention as fa, fused_ffn as ff

    errs = {k: [] for k in ("sh_attention_fwd", "sh_attention_saved",
                            "sh_attention_drop_fwd",
                            "sh_attention_saveqkv_fwd", "ffn_fwd",
                            "ffn_drop_fwd")}

    def held(key, what, dtype, err, tol):
        if not (math.isfinite(err) and err <= tol):
            fail(f"{what} {dtype}: err {err} > {tol}")
        if dtype == torch.float32:
            errs[key].append(err)
        return f"{err:.3e}"

    for name, p, tq, tk, self_attn in ATTN_TRAIN:
        mask = _attn_mask(torch, dev, tq, tk, self_attn)
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, 2.0 ** -5)):
            args = _attn_args(torch, dev, p, tq, tk, dtype, seed=tq + tk)
            e = held("sh_attention_fwd", f"sh_attention {name} (train shape)",
                     dtype, err_of(fa.fused_sh_attention(*args, mask),
                                   fa.sh_attention_reference(*args, mask)),
                     tol)
            log(f"sh_attention {name} P={p} {tq}x{tk} {dtype}: err {e} "
                f"(tol {tol})")
    for i, (name, p, tq, tk, self_attn) in enumerate(ATTN_EVAL):
        mask = _attn_mask(torch, dev, tq, tk, self_attn)
        seed = _seed(torch, dev, 70 + i)
        ak, ok = dm.dropout_keep_masks(seed, p, tq, tk, 512, keep_prob=KEEP)
        fed = dict(attn_keep=ak, out_keep=ok, keep_prob=KEEP)
        for dtype in (torch.float32, torch.bfloat16):
            tol = F32_TOL if dtype == torch.float32 else 2.0 ** -5
            args = _attn_args(torch, dev, p, tq, tk, dtype, seed=tq + tk)
            line = []
            for key, mode, drop, plain in (
                    ("sh_attention_saved", "saved", {}, {}),
                    ("sh_attention_drop_fwd", "seed",
                     dict(seed=seed, keep_prob=KEEP), fed),
                    ("sh_attention_drop_fwd", "operand masks", fed, fed)):
                out, oh = fa.fused_sh_attention_saved(*args, mask, **drop)
                rout, roh = fa.sh_attention_saved_reference(*args, mask,
                                                            **plain)
                what = f"sh_attention {mode} {name} (eval shape)"
                e_out = held(key, what, dtype, err_of(out, rout), tol)
                e_oh = held(key, what, dtype,
                            _saved_err(torch, oh, roh, dtype), tol)
                line.append(f"{mode}: out {e_out} saved {e_oh}")
                del out, oh, rout, roh
            out, oh, qkv = fa.fused_sh_attention_saved(*args, mask,
                                                       save_qkv=True)
            rout, roh, want = fa.sh_attention_saved_reference(
                *args, mask, save_qkv=True)
            what = f"save-qkv {name} (eval shape)"
            key = "sh_attention_saveqkv_fwd"
            qtol = F32_TOL if dtype == torch.float32 else 2.0 ** -6
            e_out = held(key, what, dtype, err_of(out, rout), tol)
            e_oh = held(key, what, dtype, _saved_err(torch, oh, roh, dtype),
                        tol)
            e_qkv = [held(key, what, dtype, _saved_err(torch, a, b, dtype),
                          qtol) for a, b in zip(qkv, want)]
            line.append(f"save-qkv: out {e_out} saved {e_oh} q/k/v {e_qkv}")
            del out, oh, qkv, rout, roh, want
            log(f"sh_attention {name} P={p} {tq}x{tk} {dtype} (eval shape): "
                + "; ".join(line))
        del ak, ok, fed

    g = torch.Generator(device="cpu").manual_seed(8)
    d, hid = 512, 2048
    for name, n, drop in (("encoder (train)", B * ROIS * 56, False),
                          ("decoder (train)", B * ROIS * 64, False),
                          ("encoder (eval)", 300 * B * 56, True),
                          ("decoder (eval)", 300 * B * 64, True)):
        base = [torch.randn(n, d, generator=g),
                torch.randn(d, hid, generator=g) * d ** -0.5,
                0.05 * torch.randn(hid, generator=g),
                torch.randn(hid, d, generator=g) * hid ** -0.5,
                0.05 * torch.randn(d, generator=g),
                1 + 0.1 * torch.randn(d, generator=g),
                0.1 * torch.randn(d, generator=g)]
        base = [t.to(dev) for t in base]
        kw, plain, key = {}, {}, "ffn_fwd"
        if drop:
            seed = _seed(torch, dev, 80 + n % 7)
            kw = dict(seed=seed, keep_prob=KEEP)
            plain = dict(keep=dm.ffn_keep_mask(seed, n, d, keep_prob=KEEP),
                         keep_prob=KEEP)
            key = "ffn_drop_fwd"
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, 2.0 ** -6)):
            args = [base[0].to(dtype), base[1].to(dtype), base[2],
                    base[3].to(dtype), base[4], base[5], base[6]]
            e = held(key, f"ffn {name}{' dropout' if drop else ''}", dtype,
                     err_of(ff.fused_ffn(*args, **kw),
                            ff.ffn_reference(*args, **plain)), tol)
            log(f"ffn{' dropout' if drop else ''} {name} N={n} {dtype}: err "
                f"{e} (tol {tol})")
        del base, args, plain
    return {k: max(v) for k, v in errs.items()}


# ---------------------------------------------------------- train kernels


def rel_err(got, want):
    """max |got - want| over max |want|."""
    return ((got.float() - want.float()).abs().max() /
            want.float().abs().max().clamp(min=1e-30)).item()


def check_grads(name, got, want, tol):
    """Every cotangent within tol of its max |plain|; returns (the largest
    such relative error, the largest absolute error)."""
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    if len(got) != len(want) or not all(math.isfinite(e) and e <= tol
                                        for e in errs):
        fail(f"{name}: cotangent errors {errs} (tol {tol} of max |plain|)")
    return max(errs), max((a.float() - b.float()).abs().max().item()
                          for a, b in zip(got, want))


# the train path's attention calls at a batch of 8 images x 128 rois:
# (name, pairs, Tq, Tk, self-attention)
ATTN_TRAIN = (("encoder self", B * ROIS, 56, 56, True),
              ("decoder self", B, 64, 64, True),
              ("decoder cross", B * ROIS, 64, 56, False))


def _attn_mask(torch, dev, tq, tk, self_attn):
    tok = torch.arange(64, device=dev)
    if tq == 64 and self_attn:
        return torch.tril(torch.ones(64, 64, dtype=torch.bool, device=dev))
    return (tok[:tk] < 49)[None, :].expand(tq, tk).contiguous()


def check_attention_train(torch, dev):
    """Kernel A (forward with saved per-head outputs) and kernel D (the
    backward from them)."""
    from ait_tpu_torch.ops import fused_attention as fa

    res = {"saved": [[], 0.0, 0.0, 0.0], "bwd": [[], 0.0, 0.0, 0.0]}
    for name, p, tq, tk, self_attn in ATTN_TRAIN:
        mask = _attn_mask(torch, dev, tq, tk, self_attn)
        gen = torch.Generator(device="cpu").manual_seed(p + tq)
        for dtype in (torch.float32, torch.bfloat16):
            args = _attn_args(torch, dev, p, tq, tk, dtype, seed=tq + tk)
            out, oh = fa.fused_sh_attention_saved(*args, mask)
            rout, roh = fa.sh_attention_saved_reference(*args, mask)
            e_out, e_oh = err_of(out, rout), (oh - roh).abs().max().item()
            if dtype == torch.float32:
                tol_out = tol_oh = F32_TOL
                tol_bwd = BWD_REL
            else:
                # the output as the eval check's; the saved outputs in units
                # of max(1, |plain|): the plain version rounds q/k/v and the
                # probabilities to bf16 before P v, the kernel keeps f32
                tol_out = tol_oh = 2.0 ** -5
                e_oh = ((oh - roh).abs() /
                        roh.abs().clamp(min=1.0)).max().item()
                tol_bwd = BF16_BWD_REL
            if not (e_out <= tol_out and e_oh <= tol_oh):
                fail(f"sh_attention_saved {name} {dtype}: out err {e_out} "
                     f"(tol {tol_out}), saved err {e_oh} (tol {tol_oh})")
            g = torch.randn(out.shape, generator=gen).to(dev, dtype)
            got = fa.fused_sh_attention_bwd(*args, mask, oh, g)
            want = fa.sh_attention_bwd_reference(*args, mask, oh, g)
            e_bwd, abs_bwd = check_grads(f"sh_attention_bwd {name} {dtype}",
                                         got, want, tol_bwd)
            if dtype == torch.float32:
                res["saved"][0].append(max(e_out, e_oh))
                res["bwd"][0].append(abs_bwd)
            log(f"sh_attention train {name} P={p} {tq}x{tk} {dtype}: out "
                f"err {e_out:.3e}, saved err {e_oh:.3e}, bwd rel err "
                f"{e_bwd:.3e} (tol {tol_bwd}), abs err {abs_bwd:.3e}")
        # timed in bf16, the train path's type
        ms_a = cuda_ms(lambda: fa.fused_sh_attention_saved(*args, mask))
        plain_a = cuda_ms(lambda: fa.sh_attention_saved_reference(*args,
                                                                  mask))
        ms_d = cuda_ms(lambda: fa.fused_sh_attention_bwd(*args, mask, oh, g),
                       iters=5)
        plain_d = cuda_ms(lambda: fa.sh_attention_bwd_reference(
            *args, mask, oh, g), iters=5)
        bounds = attn_bounds(p, tq, tk, self_attn, False)
        (b_a, by_a), (b_d, by_d) = bounds["saved"], bounds["bwd"]
        log(f"sh_attention_saved {name}: kernel_ms {ms_a:.3f} plain_ms "
            f"{plain_a:.3f} bound_ms {b_a:.4f} ({by_a})")
        log(f"sh_attention_bwd {name}: kernel_ms {ms_d:.3f} plain_ms "
            f"{plain_d:.3f} bound_ms {b_d:.4f} ({by_d})")
        for key, vals in (("saved", (ms_a, plain_a, b_a)),
                          ("bwd", (ms_d, plain_d, b_d))):
            for i, v in enumerate(vals):
                res[key][i + 1] += v
    return {k: {"max_abs_err": max(v[0]), "ms": v[1], "plain_ms": v[2],
                "bound_ms": v[3], "bound_by": "operations"}
            for k, v in res.items()}


# the per-pair backward kernel against its plain version on the same
# projections, each output over its max |plain| (tests/test_torch_bwd_
# redesign.py holds it to the same): f32, the six-term split products
# (near-f32) and the order of sums, between the kernel's 1.7e-6 on an H100
# and the 7.3e-6 to 1.3e-5 that the three-term split's emulation reaches on
# the CPU (tests/test_torch_bwd_redesign.py);
# bf16, o rounded to bf16 after sums in another order moves a few elements
# of o by an ulp (2^-8) and all that follows
PAIR_F32_REL, PAIR_BF16_REL = 5e-6, 2e-2
PAIR_OUTPUTS = ("dy", "o", "s", "dlogit", "ln partials", "dz", "dk", "dv",
                "dy0")


def pair_bound(p, tq, tk, dropout):
    """The per-pair kernel's own bound: f32 q, k, v and oh and bf16 g and
    x_q read once, f32 dy, o, dz, dk, dv (dy0 with dropout) written once;
    its ~29 MFLOP a pair at the bf16 rate."""
    d, h, dk = 512, 8, 64
    nbytes = (p * (tq + 2 * tk) * d * 4 + h * p * tq * dk * 4 +
              2 * p * tq * d * 2 + p * tq * d * 4 * (3 if dropout else 2) +
              p * tq * dk * 4 + 2 * p * tk * d * 4 + p * (dk + 3 * d) * 4)
    flops = p * (2 * 2 * tq * dk * d + h * 5 * 2 * tq * tk * dk)
    return bound(nbytes, flops, BF16_FLOP_S)


def check_bwd_pairs(torch, dev):
    """The per-pair backward kernel alone (`short_bwd_pairs`, csrc/
    sh_attention.cu sh_attn_bwd_kernel) against its plain version
    (`sh_attention_bwd_pairs_reference`) on the same projections at the
    train shapes: f32 and bf16, without dropout, with the seed's stream and
    with operand masks; from the saved q/k/v its outputs bit-equal to those
    from the projections.  Its per-head products alone (`split_check`)
    within SPLIT_BOUND of the exact product.  Times it in bf16 with the
    seed's dropout (the train path's form) beside its own bound: an error
    of the backward is then the per-pair kernel's or the products'."""
    from ait_tpu_torch.ops import dropout_masks as dm, fused_attention as fa

    g64 = torch.Generator(device=dev).manual_seed(5)
    split_err = 0.0
    for ta in (False, True):
        for tb in (False, True):
            a = torch.randn(64, 64, 64, generator=g64, device=dev)
            b = torch.rand(64, 64, 64, generator=g64, device=dev) * \
                torch.exp2(torch.randint(-20, 20, (64, 64, 64), device=dev,
                                         generator=g64).float())
            got = fa.split_check(a, b, ta, tb)
            a2 = (a.transpose(1, 2) if ta else a).double()
            b2 = (b.transpose(1, 2) if tb else b).double()
            e = ((got.double() - a2 @ b2).abs() /
                 (a2.abs() @ b2.abs())).max().item()
            if not e <= fa.SPLIT_BOUND:
                fail(f"split_check ta={ta} tb={tb}: error {e} of sum |a||b| "
                     f"> {fa.SPLIT_BOUND}")
            split_err = max(split_err, e)
    log(f"sh_attn_bwd_kernel per-head products (split_check): max error "
        f"{split_err:.3e} of sum_k |a_k| |b_k| (bound {fa.SPLIT_BOUND:.3e})")
    res = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "err": 0.0}
    for i, (name, p, tq, tk, self_attn) in enumerate(ATTN_TRAIN):
        mask = _attn_mask(torch, dev, tq, tk, self_attn)
        gen = torch.Generator(device="cpu").manual_seed(p + tq + 2)
        seed = _seed(torch, dev, 40 + i)
        ak, ok = dm.dropout_keep_masks(seed, p, tq, tk, 512, keep_prob=KEEP)
        for dtype in (torch.float32, torch.bfloat16):
            args = _attn_args(torch, dev, p, tq, tk, dtype, seed=tq + tk)
            x_q, sk_w, sk_b, fc_w, ln_s = (args[0], args[5], args[6],
                                           args[7], args[8])
            proj = fa.project(*args[:5])
            oh = fa.sh_attention_saved_reference(*args, mask)[1]
            g = torch.randn((p, tq, 512), generator=gen).to(dev, dtype)
            tol = PAIR_F32_REL if dtype == torch.float32 else PAIR_BF16_REL
            for source, kdrop, plain in (
                    ("none", fa._NO_DROP, {}),
                    ("seed", fa._kernel_drop("pairs", x_q, p, tq, tk, KEEP,
                                             seed, None, None),
                     dict(attn_keep=ak, out_keep=ok, keep_prob=KEEP)),
                    ("operand masks", fa._kernel_drop(
                        "pairs", x_q, p, tq, tk, KEEP, None, ak, ok),
                     dict(attn_keep=ak, out_keep=ok, keep_prob=KEEP))):
                got = fa.short_bwd_pairs(x_q, proj, sk_w, sk_b, fc_w, ln_s,
                                         mask, oh, g, tk, False, kdrop)
                want = fa.sh_attention_bwd_pairs_reference(
                    *proj, sk_w, sk_b, fc_w, x_q, ln_s, mask, oh, g, **plain)
                errs = [rel_err(a, b) for a, b in zip(got, want)]
                if not all(math.isfinite(e) and e <= tol for e in errs):
                    fail(f"sh_attn_bwd_kernel {name} {dtype} ({source}): "
                         f"errors {dict(zip(PAIR_OUTPUTS, errs))} of max "
                         f"|plain| (tol {tol})")
                if dtype == torch.float32:
                    res["err"] = max(res["err"], max(
                        (a - b).abs().max().item() for a, b in zip(got, want)))
                log(f"sh_attn_bwd_kernel {name} P={p} {tq}x{tk} {dtype} "
                    f"({source}): max err {max(errs):.3e} of max |plain| "
                    f"(tol {tol}; worst {PAIR_OUTPUTS[errs.index(max(errs))]})")
            # from the saved q/k/v (heads-major, q pre-scaled): bit-equal
            saved = (torch.stack(proj[0].view(p * tq, 8, 64).unbind(1)) *
                     0.125,
                     torch.stack(proj[1].view(p * tk, 8, 64).unbind(1)),
                     torch.stack(proj[2].view(p * tk, 8, 64).unbind(1)))
            kdrop = fa._kernel_drop("pairs", x_q, p, tq, tk, KEEP, seed, None,
                                    None)
            a = fa.short_bwd_pairs(x_q, proj, sk_w, sk_b, fc_w, ln_s, mask, oh,
                                   g, tk, False, kdrop)
            b = fa.short_bwd_pairs(x_q, saved, sk_w, sk_b, fc_w, ln_s, mask,
                                   oh, g, tk, True, kdrop)
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                fail(f"sh_attn_bwd_kernel {name} {dtype}: the saved q/k/v "
                     "give other bits than the projections")
            del saved, a, b
        # timed in bf16 with the seed's dropout, the train path's form
        ms = cuda_ms(lambda: fa.short_bwd_pairs(
            x_q, proj, sk_w, sk_b, fc_w, ln_s, mask, oh, g, tk, False, kdrop))
        plain_ms = cuda_ms(lambda: fa.sh_attention_bwd_pairs_reference(
            *proj, sk_w, sk_b, fc_w, x_q, ln_s, mask, oh, g, attn_keep=ak,
            out_keep=ok, keep_prob=KEEP), iters=3, warmup=1)
        t_bound, by = pair_bound(p, tq, tk, True)
        log(f"sh_attn_bwd_kernel {name}: kernel_ms {ms:.4f} plain_ms "
            f"{plain_ms:.3f} bound_ms {t_bound:.4f} ({by}); saved q/k/v "
            "bit-equal")
        res["ms"] += ms
        res["plain_ms"] += plain_ms
        res["bound_ms"] += t_bound
        del proj, oh, g
    log(f"sh_attn_bwd_kernel per train step (3 calls, bf16, seed dropout): "
        f"kernel_ms {res['ms']:.4f} plain_ms {res['plain_ms']:.3f} bound_ms "
        f"{res['bound_ms']:.4f}")
    return {"pairs_ms": res["ms"], "pairs_plain_ms": res["plain_ms"],
            "pairs_bound_ms": res["bound_ms"], "pairs_max_abs_err": res["err"],
            "split_err": split_err}


def ffn_relu_ties(torch, args):
    """The FFN backward's relu mask on the kernel path (its recompute of
    y1 on csrc/gemm.cu's tensor cores) and the number of ties: elements
    where it differs from the plain version's (f32 sums in cuBLAS's order).
    Each tie must be a pre-activation inside both sums' f32 error bound,
    2 gamma_K sum_k |x_k w_k| + 2 u (|v| + |b|) (gamma_K = K u / (1 - K u),
    u = 2^-24): there either sign is right, and the relu's derivative jumps,
    so a bf16 backward is held to its plain version fed this mask."""
    from ait_tpu_torch.ops import _gemm

    x, w1, b1 = args[0], args[1], args[2]
    mask = _gemm.gemm(_gemm.NN, x, w1, bias=b1, relu=True,
                      out_dtype=x.dtype) > 0
    xf, wf = x.float(), w1.float()
    pre = xf @ wf + b1
    ties = mask != (pre > 0)
    u, k = 2.0 ** -24, x.shape[1]
    gamma = k * u / (1 - k * u)
    bound = 2 * gamma * (xf.abs() @ wf.abs()) + 2 * u * (pre.abs() + b1.abs())
    if (ties & (pre.abs() > bound)).any():
        fail("ffn_bwd: the kernel's relu mask differs from the plain "
             "version's beyond f32 rounding")
    return mask, int(ties.sum())


def check_ffn_train(torch, dev):
    """Kernel B: the FFN backward, recomputed from x."""
    from ait_tpu_torch.ops.fused_ffn import ffn_bwd_reference, fused_ffn_bwd

    g = torch.Generator(device="cpu").manual_seed(5)
    d, hid = 512, 2048
    errs, ms_sum, plain_sum, bound_sum = [], 0.0, 0.0, 0.0
    for name, n in (("encoder", B * ROIS * 56), ("decoder", B * ROIS * 64)):
        base = [torch.randn(n, d, generator=g),
                torch.randn(d, hid, generator=g) * d ** -0.5,
                0.05 * torch.randn(hid, generator=g),
                torch.randn(hid, d, generator=g) * hid ** -0.5,
                0.05 * torch.randn(d, generator=g),
                1 + 0.1 * torch.randn(d, generator=g),
                0.1 * torch.randn(d, generator=g),
                torch.randn(n, d, generator=g)]
        base = [t.to(dev) for t in base]
        for dtype, tol in ((torch.float32, BWD_REL),
                           (torch.bfloat16, BF16_BWD_REL)):
            args = [base[0].to(dtype), base[1].to(dtype), base[2],
                    base[3].to(dtype), base[4], base[5], base[6],
                    base[7].to(dtype)]
            # f32: the FMA tiles sum in the plain version's order; bf16:
            # the tensor cores' order, ties fed to the plain version
            mask, ties = (ffn_relu_ties(torch, args)
                          if dtype == torch.bfloat16 else (None, 0))
            err, abs_err = check_grads(f"ffn_bwd {name} {dtype}",
                                       fused_ffn_bwd(*args),
                                       ffn_bwd_reference(*args,
                                                         relu_mask=mask), tol)
            if dtype == torch.float32:
                errs.append(abs_err)
            log(f"ffn_bwd {name} N={n} {dtype}: rel err {err:.3e} "
                f"(tol {tol}), abs err {abs_err:.3e}, relu ties {ties}")
        ms = cuda_ms(lambda: fused_ffn_bwd(*args), iters=3, warmup=1)
        plain_ms = cuda_ms(lambda: ffn_bwd_reference(*args), iters=3,
                           warmup=1)
        # x, g in; dx out; w1, w2 in and their gradients out (bf16); the
        # products: y1 and y2 recomputed, dy1, dx, dw1, dw2
        t_bound, by = bound(3 * n * d * 2 + 4 * d * hid * 2 +
                            2 * (hid + 3 * d) * 4, 12 * n * d * hid,
                            BF16_FLOP_S)
        log(f"ffn_bwd {name}: kernel_ms {ms:.3f} plain_ms {plain_ms:.3f} "
            f"bound_ms {t_bound:.4f} ({by})")
        ms_sum, plain_sum, bound_sum = (ms_sum + ms, plain_sum + plain_ms,
                                        bound_sum + t_bound)
    return {"max_abs_err": max(errs), "ms": ms_sum, "plain_ms": plain_sum,
            "bound_ms": bound_sum, "bound_by": "operations"}


def same_param_grads(name, got, again):
    """dln_s and dln_b (entries 2 and 3 of `fused_posln_bwd`'s result, 1
    and 2 of `_ln_bwd`'s, 5 and 6 of `fused_ffn_bwd`'s) bit-equal over two
    calls: csrc/posln.cu sums them in a fixed order, no atomics."""
    import torch

    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"{name}: dln_s / dln_b differ between two calls")


def check_posln_train(torch, dev):
    """Kernel C: the glue's LayerNorm backward (csrc/posln.cu `ln_bwd`, no
    dropout) at the train step's two calls against torch autograd through
    the plain forward, its parameter gradients bit-equal over two calls;
    device time, bound, plain time and the LayerNorm-backward yardstick."""
    from ait_tpu_torch.models.layers import sinusoid_table
    from ait_tpu_torch.ops.fused_ffn import (fused_posln_bwd,
                                             posln_bwd_reference)

    g = torch.Generator(device="cpu").manual_seed(6)
    d = 512
    errs, sums = [], [0.0] * 4            # ms, plain, bound, yardstick
    for name, n, t in (("encoder", B * ROIS * 56, 56), ("decoder", B * 64,
                                                        64)):
        x = torch.randn(n, d, generator=g).to(dev)
        gy = torch.randn(n, d, generator=g).to(dev)
        pos = torch.from_numpy(sinusoid_table(64, d)[:t]).to(dev)
        ln_s = (1 + 0.1 * torch.randn(d, generator=g)).to(dev)
        ln_b = (0.1 * torch.randn(d, generator=g)).to(dev)
        for dtype, tol in ((torch.float32, BWD_REL),
                           (torch.bfloat16, BF16_BWD_REL)):
            args = (x.to(dtype), pos.to(dtype), ln_s, ln_b, gy.to(dtype))
            got = fused_posln_bwd(*args)
            same_param_grads(f"posln_bwd {name} {dtype}", got[2:],
                             fused_posln_bwd(*args)[2:])
            err, abs_err = check_grads(f"posln_bwd {name} {dtype}", got,
                                       posln_bwd_reference(*args), tol)
            if dtype == torch.float32:
                errs.append(abs_err)
            log(f"posln_bwd {name} N={n} {dtype}: rel err {err:.3e} "
                f"(tol {tol}), abs err {abs_err:.3e}, dln bit-equal over "
                "two calls")
        ms = device_ms(lambda: fused_posln_bwd(*args))
        event_ms = cuda_ms(lambda: fused_posln_bwd(*args), iters=20)
        plain_ms = cuda_ms(lambda: posln_bwd_reference(*args), iters=20)
        yard = layer_norm_yardstick(torch, (args[0].float() + args[1].float(
        ).repeat(n // t, 1)).to(dtype), args[4])
        t_bound, by = bound(3 * n * d * 2 + 2 * t * d * 2 + 4 * d * 4,
                            14 * n * d, F32_FLOP_S)
        log(f"posln_bwd {name}: kernel_ms {ms:.4f} (device; event "
            f"{event_ms:.4f}) plain_ms {plain_ms:.4f} bound_ms "
            f"{t_bound:.4f} ({by}) yardstick_ms {yard:.4f}")
        sums = [a + b for a, b in zip(sums, (ms, plain_ms, t_bound, yard))]
    return {"max_abs_err": max(errs), "ms": sums[0], "plain_ms": sums[1],
            "bound_ms": sums[2], "bound_by": "bytes", "yardstick_ms": sums[3]}


def check_ffn_ln_bwd(torch, dev):
    """csrc/posln.cu `ln_bwd` in the FFN backward's mode, alone, at the
    default train step's two FFN calls (57,344 and 65,536 rows): bf16 x and
    g, the f32 addend y2 (the FFN's recomputed output), f32 dy and, with
    the FFN's output dropout from a seed (the default step's form), dy2;
    against its plain version `ln_bwd_reference` fed the dumped mask (every
    output within BWD_REL of its max |plain|), dln_s and dln_b bit-equal
    over two calls.  The keep_prob 1 form (t_dropout 0) is held and timed
    too, and logged; the entry's numbers are the dropout form's."""
    from ait_tpu_torch.ops import dropout_masks as dm, fused_ffn as ff, philox

    g = torch.Generator(device="cpu").manual_seed(8)
    d = 512
    errs, sums = [], [0.0] * 4            # ms, plain, bound, yardstick
    for i, (name, n) in enumerate((("encoder", B * ROIS * 56),
                                   ("decoder", B * ROIS * 64))):
        x = torch.randn(n, d, generator=g).to(dev, torch.bfloat16)
        y2 = torch.randn(n, d, generator=g).to(dev)
        gy = torch.randn(n, d, generator=g).to(dev, torch.bfloat16)
        ln_s = (1 + 0.1 * torch.randn(d, generator=g)).to(dev)
        seed = _seed(torch, dev, 50 + i)
        keep = dm.ffn_keep_mask(seed, n, d, keep_prob=KEEP)
        forms = (("dropout", ff._LN_FFN, (seed.data_ptr(),
                                          philox.keep_threshold(KEEP),
                                          1.0 / KEEP), keep),
                 ("keep_prob 1", ff._LN_PLAIN, (None, 0, 1.0), None))
        for form, mode, drop, mask in forms:
            def run(mode=mode, drop=drop):
                return ff._ln_bwd(x, y2, n, ln_s, gy, torch.float32, mode,
                                  drop)

            def plain(mode=mode, mask=mask):
                return ff.ln_bwd_reference(x, y2, n, ln_s, gy, mode, mask,
                                           KEEP)

            got = run()
            same_param_grads(f"ln_bwd ffn {form} {name}", got[1:3],
                             run()[1:3])
            want = plain()
            pairs = [(u, v) for u, v in zip(got, want) if v is not None]
            err, abs_err = check_grads(f"ln_bwd ffn {form} {name}",
                                       [u for u, _ in pairs],
                                       [v for _, v in pairs], BWD_REL)
            ms = device_ms(run)
            plain_ms = cuda_ms(plain, iters=3, warmup=1)
            y = x.float() + (y2 if mask is None else y2 * mask / KEEP)
            yard = layer_norm_yardstick(torch, y, gy)
            # x, g bf16 and y2 f32 in, dy (and dy2) f32 out; ~14 f32
            # operations an element and the Philox draws
            nbytes = n * d * (2 + 4 + 2 + 4 + (4 if mask is not None else 0))
            t_bytes = (nbytes + 3 * d * 4) / HBM_BYTES_S * 1e3
            t_ops = (14 * n * d / F32_FLOP_S +
                     (philox_s(n * d / 4) if mask is not None else 0)) * 1e3
            t_bound = max(t_bytes, t_ops)
            by = "bytes" if t_bytes >= t_ops else "operations"
            log(f"ln_bwd ffn {form} {name} N={n}: rel err {err:.3e} (tol "
                f"{BWD_REL}), abs err {abs_err:.3e}, dln bit-equal over two "
                f"calls; kernel_ms {ms:.4f} (device) plain_ms {plain_ms:.3f}"
                f" bound_ms {t_bound:.4f} ({by}) yardstick_ms {yard:.4f}")
            if form == "dropout":
                errs.append(abs_err)
                sums = [a + b for a, b in zip(sums, (ms, plain_ms, t_bound,
                                                     yard))]
    return {"max_abs_err": max(errs), "ms": sums[0], "plain_ms": sums[1],
            "bound_ms": sums[2], "bound_by": "bytes", "yardstick_ms": sums[3]}


# ---------------------------------------------------------------- dropout


# the co-attention's plain-path dropout masks per train step at B = 8 (the
# main path's dump launches): image tokens 38 x 50 at stride 16, 64 query
# tokens; (tag, heads, blocks, length) per dump
COATT_DUMPS = ((1, 8, B, 1900 * 64), (2, 1, B, 1900 * 512),
               (1, 8, B, 64 * 1900), (2, 1, B, 64 * 512))


def _seed(torch, dev, i):
    g = torch.Generator(device="cpu").manual_seed(100 + i)
    return torch.randint(-2 ** 31, 2 ** 31, (2,), dtype=torch.int32,
                         generator=g).to(dev)


def check_masks(torch, dev):
    """The dump kernel at the train path's shapes: bit-equal to the plain
    Philox stream, two launches bit-equal, keep rate within 0.01 of KEEP,
    and tiling-independent; held likewise (but for the second launch) and
    timed at the co-attention's dumps, the main path's."""
    from ait_tpu_torch.ops import dropout_masks as dm, philox

    dumps = []
    for i, (name, p, tq, tk, _) in enumerate(ATTN_TRAIN):
        seed = _seed(torch, dev, i)
        dumps.append((f"attention {name}", seed, lambda s=seed, p=p, tq=tq,
                      tk=tk: dm.dropout_keep_masks(s, p, tq, tk, 512,
                                                   keep_prob=KEEP)))
    for i, (name, fn, n) in enumerate((
            ("ffn encoder", dm.ffn_keep_mask, B * ROIS * 56),
            ("ffn decoder", dm.ffn_keep_mask, B * ROIS * 64),
            ("glue encoder", dm.posln_keep_mask, B * ROIS * 56),
            ("glue decoder", dm.posln_keep_mask, B * 64))):
        seed = _seed(torch, dev, 10 + i)
        dumps.append((name, seed, lambda s=seed, f=fn, n=n: (
            f(s, n, 512, keep_prob=KEEP),)))
    with plain_path():
        want_all = [[m.clone() for m in fn()] for _, _, fn in dumps]
    g = torch.Generator(device=dev).manual_seed(0)
    errs = []

    def held(name, got, want, again=None):
        """Fail unless the dump is bit-equal to the plain stream (and to a
        second launch) with a keep rate within 0.01 of KEEP."""
        errs.append((got - want).abs().max().item())
        if not (torch.equal(got, want) and
                (again is None or torch.equal(got, again))):
            fail(f"mask dump {name} {tuple(want.shape)}: not bit-equal to "
                 "the plain Philox stream or not deterministic")
        rate = got.mean().item()
        if abs(rate - KEEP) > 0.01:
            fail(f"mask dump {name}: keep rate {rate} (want {KEEP})")
        log(f"mask dump {name} {tuple(want.shape)}: bit-equal to the plain "
            f"stream{', two launches equal' if again is not None else ''}, "
            f"keep rate {rate:.5f}")

    for (name, seed, fn), want in zip(dumps, want_all):
        got, again = fn(), fn()
        for g1, g2, w in zip(got, again, want):
            held(name, g1, w, g2)
        # the check path's dumps, timed: the kernel, its plain version, and
        # torch.rand < p of the same shapes (other bits)
        n = sum(m.numel() for m in want)
        ms = cuda_ms(fn, iters=20)
        with plain_path():
            plain_ms = cuda_ms(fn, iters=2, warmup=1)
        lib_ms = cuda_ms(lambda: [torch.rand(m.shape, generator=g,
                                             device=dev) < KEEP
                                  for m in want], iters=20)
        t_bound = max(bound(n * 4 + 8, 0, F32_FLOP_S)[0],
                      philox_s(n / 4) * 1e3)
        log(f"mask dump {name}: kernel_ms {ms:.4f} plain_ms {plain_ms:.3f} "
            f"library_ms {lib_ms:.4f} bound_ms {t_bound:.4f}")
    # a pair's masks do not depend on how many pairs one dump covers
    seed = dumps[0][1]
    small = dm.dropout_keep_masks(seed, 4, 56, 56, 512, keep_prob=KEEP)
    big = dumps[0][2]()
    if not (torch.equal(small[0], big[0][:, :4 * 56]) and
            torch.equal(small[1], big[1][:4 * 56])):
        fail("mask dump: pairs 0-3 differ between a 4-pair and a 1024-pair "
             "dump")
    log("mask dump: pairs 0-3 equal in a 4-pair and a 1024-pair dump")

    # held and timed at the main path's shapes (the co-attention's dumps):
    # on the device (torch.profiler), and by CUDA events around the wrapper
    seed = _seed(torch, dev, 20)
    ms = event_ms = plain_ms = lib_ms = t_bytes = t_ops = 0.0
    for tag, heads, blocks, length in COATT_DUMPS:
        held(f"co-attention tag {tag}",
             dm.keep_mask(seed, tag, heads, blocks, length, KEEP),
             philox.keep_mask(seed, tag, heads, blocks, length, KEEP))
        ms += device_ms(lambda: dm.keep_mask(seed, tag, heads, blocks,
                                             length, KEEP), iters=50)
        event_ms += cuda_ms(lambda: dm.keep_mask(seed, tag, heads, blocks,
                                                 length, KEEP), iters=20)
        plain_ms += cuda_ms(lambda: philox.keep_mask(
            seed, tag, heads, blocks, length, KEEP), iters=3, warmup=1)
        # one PyTorch call for a Bernoulli(KEEP) mask of the same shape (it
        # draws other bits than the port's stream)
        lib_ms += cuda_ms(lambda: torch.rand(
            (heads, blocks, length), generator=g, device=dev) < KEEP,
            iters=20)
        n = heads * blocks * length
        t_bytes += bound(n * 4 + 8, 0, F32_FLOP_S)[0]
        t_ops += philox_s(n / 4) * 1e3
    t_bound = max(t_bytes, t_ops)
    by = "bytes" if t_bytes >= t_ops else "operations"
    log(f"keep_mask_dump (the co-attention's 4 dumps per step): device ms "
        f"{ms:.4f} ({t_bound / ms:.0%} of the bound; event ms {event_ms:.4f}) "
        f"plain_ms {plain_ms:.3f} library_ms (torch.rand < p) {lib_ms:.4f} "
        f"bound_ms {t_bound:.4f} ({by}; bytes {t_bytes:.4f}, Philox "
        f"{t_ops:.4f})")
    return {"max_abs_err": max(errs), "ms": ms, "event_ms": event_ms,
            "plain_ms": plain_ms, "bound_ms": t_bound, "bound_by": by,
            "library_ms": lib_ms}


def _res():
    return [[], 0.0, 0.0, 0.0]


def _finish(res, by):
    return {"max_abs_err": max(res[0]), "ms": res[1], "plain_ms": res[2],
            "bound_ms": res[3], "bound_by": by}


def check_attention_dropout(torch, dev):
    """The attention's dropout forms: the saved-outputs forward and the
    backward with masks from a seed (the train path's form) and from operand
    masks, against the plain versions fed the dumped masks.  The forward
    tolerances are the eval check's, with room in bf16 for the plain
    version's output-dropout factor 1 / 0.9 rounded to bf16 (1.109375, as
    `_reference_impl` rounds it; the kernel multiplies in f32), 0.16% of
    fc's output."""
    from ait_tpu_torch.ops import dropout_masks as dm, fused_attention as fa

    d = 512
    res = {"fwd": _res(), "bwd": _res()}
    for i, (name, p, tq, tk, self_attn) in enumerate(ATTN_TRAIN):
        mask = _attn_mask(torch, dev, tq, tk, self_attn)
        gen = torch.Generator(device="cpu").manual_seed(p + tq + 1)
        seed = _seed(torch, dev, 30 + i)
        ak, ok = dm.dropout_keep_masks(seed, p, tq, tk, d, keep_prob=KEEP)
        fed = dict(attn_keep=ak, out_keep=ok, keep_prob=KEEP)
        for dtype in (torch.float32, torch.bfloat16):
            args = _attn_args(torch, dev, p, tq, tk, dtype, seed=tq + tk)
            g = torch.randn((p, tq, d), generator=gen).to(dev, dtype)
            rout, roh = fa.sh_attention_saved_reference(*args, mask, **fed)
            want = fa.sh_attention_bwd_reference(*args, mask, roh, g, **fed)
            for source, drop in (("seed", dict(seed=seed, keep_prob=KEEP)),
                                 ("operand masks", fed)):
                out, oh = fa.fused_sh_attention_saved(*args, mask, **drop)
                e_out, e_oh = err_of(out, rout), (oh - roh).abs().max().item()
                if dtype == torch.float32:
                    tol_out = tol_oh = F32_TOL
                    tol_bwd = BWD_REL
                else:
                    tol_out = tol_oh = 2.0 ** -5
                    e_oh = ((oh - roh).abs() /
                            roh.abs().clamp(min=1.0)).max().item()
                    tol_bwd = BF16_BWD_REL
                if not (e_out <= tol_out and e_oh <= tol_oh):
                    fail(f"sh_attention dropout ({source}) {name} {dtype}: "
                         f"out err {e_out} (tol {tol_out}), saved err {e_oh} "
                         f"(tol {tol_oh})")
                got = fa.fused_sh_attention_bwd(*args, mask, oh, g, **drop)
                e_bwd, abs_bwd = check_grads(
                    f"sh_attention_bwd dropout ({source}) {name} {dtype}",
                    got, want, tol_bwd)
                if dtype == torch.float32:
                    res["fwd"][0].append(max(e_out, e_oh))
                    res["bwd"][0].append(abs_bwd)
                log(f"sh_attention dropout ({source}) {name} P={p} "
                    f"{tq}x{tk} {dtype}: out err {e_out:.3e}, saved err "
                    f"{e_oh:.3e}, bwd rel err {e_bwd:.3e} (tol {tol_bwd}), "
                    f"abs err {abs_bwd:.3e}")
        # timed in bf16 from the seed, the train path's form; the plain
        # version draws its masks from the seed too (ops/philox.py)
        drop = dict(seed=seed, keep_prob=KEEP)
        ms_f = cuda_ms(lambda: fa.fused_sh_attention_saved(*args, mask,
                                                           **drop))
        plain_f = cuda_ms(lambda: fa.sh_attention_saved_reference(
            *args, mask, **drop), iters=3, warmup=1)
        ms_b = cuda_ms(lambda: fa.fused_sh_attention_bwd(*args, mask, oh, g,
                                                         **drop), iters=5)
        plain_b = cuda_ms(lambda: fa.sh_attention_bwd_reference(
            *args, mask, oh, g, **drop), iters=3, warmup=1)
        bounds = attn_bounds(p, tq, tk, self_attn, True)
        t_b = [bounds["saved"][0], bounds["bwd"][0]]
        log(f"sh_attention dropout fwd {name}: kernel_ms {ms_f:.3f} "
            f"plain_ms {plain_f:.3f} bound_ms {t_b[0]:.4f} (operations)")
        log(f"sh_attention dropout bwd {name}: kernel_ms {ms_b:.3f} "
            f"plain_ms {plain_b:.3f} bound_ms {t_b[1]:.4f} (operations)")
        for key, vals in (("fwd", (ms_f, plain_f, t_b[0])),
                          ("bwd", (ms_b, plain_b, t_b[1]))):
            for j, v in enumerate(vals):
                res[key][j + 1] += v
    return {k: _finish(v, "operations") for k, v in res.items()}


def check_rows_dropout(torch, dev):
    """The FFN's and the glue's dropout forms, forward and backward, with
    the mask from a seed, against the plain versions fed the dumped mask
    (the same tolerances as their keep_prob 1 checks); the backward's dln_s
    and dln_b bit-equal over two calls.  The glue's kernels are timed on
    the device (`device_ms`), with the LayerNorm yardstick beside them."""
    from ait_tpu_torch.models.layers import sinusoid_table
    from ait_tpu_torch.ops import dropout_masks as dm, fused_ffn as ff

    g = torch.Generator(device="cpu").manual_seed(7)
    d, hid = 512, 2048
    res = {k: _res() for k in ("ffn_fwd", "ffn_bwd", "posln_fwd",
                               "posln_bwd")}
    yard = {"posln_fwd": 0.0, "posln_bwd": 0.0}
    cases = (("ffn", "encoder", B * ROIS * 56, None),
             ("ffn", "decoder", B * ROIS * 64, None),
             ("posln", "encoder", B * ROIS * 56, 56),
             ("posln", "decoder", B * 64, 64))
    for i, (kind, name, n, t) in enumerate(cases):
        seed = _seed(torch, dev, 40 + i)
        if kind == "ffn":
            base = [torch.randn(n, d, generator=g),
                    torch.randn(d, hid, generator=g) * d ** -0.5,
                    0.05 * torch.randn(hid, generator=g),
                    torch.randn(hid, d, generator=g) * hid ** -0.5,
                    0.05 * torch.randn(d, generator=g)]
            lowp = (0, 1, 3)                 # in the compute type
            fwd, bwd = ff.fused_ffn, ff.fused_ffn_bwd
            pfwd, pbwd = ff.ffn_reference, ff.ffn_bwd_reference
            keep = dm.ffn_keep_mask(seed, n, d, keep_prob=KEEP)
        else:
            base = [torch.randn(n, d, generator=g),
                    torch.from_numpy(sinusoid_table(64, d)[:t])]
            lowp = (0, 1)
            fwd, bwd = ff.fused_posln, ff.fused_posln_bwd
            pfwd, pbwd = ff.posln_reference, ff.posln_bwd_reference
            keep = dm.posln_keep_mask(seed, n, d, keep_prob=KEEP)
        base += [1 + 0.1 * torch.randn(d, generator=g),
                 0.1 * torch.randn(d, generator=g)]
        gy = torch.randn(n, d, generator=g).to(dev)
        base = [x.to(dev) for x in base]
        drop = dict(seed=seed, keep_prob=KEEP)
        fed = dict(keep=keep, keep_prob=KEEP)
        for dtype, tol, tol_b in ((torch.float32, F32_TOL, BWD_REL),
                                  (torch.bfloat16, 2.0 ** -6, BF16_BWD_REL)):
            args = [x.to(dtype) if j in lowp else x
                    for j, x in enumerate(base)]
            gd = gy.to(dtype)
            err = err_of(fwd(*args, **drop), pfwd(*args, **fed))
            if not math.isfinite(err) or err > tol:
                fail(f"{kind} dropout {name} {dtype}: err {err} > {tol}")
            ties = {}
            if kind == "ffn" and dtype == torch.bfloat16:
                mask, n_ties = ffn_relu_ties(torch, args)
                ties = {"relu_mask": mask}
                log(f"ffn dropout {name} bf16: relu ties {n_ties}")
            got = bwd(*args, gd, **drop)
            dln = slice(5, 7) if kind == "ffn" else slice(2, 4)
            same_param_grads(f"{kind}_bwd dropout {name} {dtype}", got[dln],
                             bwd(*args, gd, **drop)[dln])
            e_b, abs_b = check_grads(f"{kind}_bwd dropout {name} {dtype}",
                                     got, pbwd(*args, gd, **fed, **ties),
                                     tol_b)
            if dtype == torch.float32:
                res[f"{kind}_fwd"][0].append(err)
                res[f"{kind}_bwd"][0].append(abs_b)
            log(f"{kind} dropout {name} N={n} {dtype}: fwd err {err:.3e} "
                f"(tol {tol}), bwd rel err {e_b:.3e} (tol {tol_b}), abs "
                f"err {abs_b:.3e}, dln bit-equal over two calls")
        if kind == "ffn":
            ms_f = cuda_ms(lambda: fwd(*args, **drop), iters=5)
            ms_b = cuda_ms(lambda: bwd(*args, gd, **drop), iters=3, warmup=1)
        else:
            ms_f = device_ms(lambda: fwd(*args, **drop))
            ms_b = device_ms(lambda: bwd(*args, gd, **drop))
            y = ((args[0].float() + args[1].float().repeat(n // t, 1)) *
                 keep / KEEP).to(dtype)
            yard["posln_fwd"] += layer_norm_yardstick(torch, y)
            yard["posln_bwd"] += layer_norm_yardstick(torch, y, gd)
        plain_f = cuda_ms(lambda: pfwd(*args, **drop), iters=3, warmup=1)
        plain_b = cuda_ms(lambda: pbwd(*args, gd, **drop), iters=3, warmup=1)
        t_philox = philox_s(n * d / 4)
        if kind == "ffn":
            specs = ((n * d * 2 * 2 + 2 * d * hid * 2 + (hid + 3 * d) * 4,
                      4 * n * d * hid),
                     (3 * n * d * 2 + 4 * d * hid * 2 + 2 * (hid + 3 * d) * 4,
                      12 * n * d * hid))
            rate = BF16_FLOP_S
        else:
            specs = ((n * d * 2 * 2 + t * d * 2 + 2 * d * 4, 8 * n * d),
                     (3 * n * d * 2 + 2 * t * d * 2 + 4 * d * 4, 14 * n * d))
            rate = F32_FLOP_S
        for key, ms, pms, (nbytes, ops) in (
                (f"{kind}_fwd", ms_f, plain_f, specs[0]),
                (f"{kind}_bwd", ms_b, plain_b, specs[1])):
            t_bytes = (nbytes + 8) / HBM_BYTES_S * 1e3
            t_ops = (ops / rate + t_philox) * 1e3
            t_bound = max(t_bytes, t_ops)
            log(f"{key} dropout {name}: kernel_ms {ms:.4f} plain_ms "
                f"{pms:.3f} bound_ms {t_bound:.4f} "
                f"({'bytes' if t_bytes >= t_ops else 'operations'})")
            for j, v in enumerate((ms, pms, t_bound)):
                res[key][j + 1] += v
    out = {k: _finish(v, "operations" if k.startswith("ffn") else "bytes")
           for k, v in res.items()}
    for k, v in yard.items():
        out[k]["yardstick_ms"] = v
    return out


# ------------------------------------------- the general attention regime


# the shapes csrc/sh_attention_general.cu serves: the co-attention's two
# attentions at a batch of 8 (38 x 50 image tokens against 64 query tokens;
# the main path under _LONG_SEQ_FUSION), and two 65-128 token shapes
# (name, pairs, Tq, Tk, mask, on the main path)
ATTN_GENERAL = (("co-attention q2i", B, 1900, 64, "none", True),
                ("co-attention i2q", B, 64, 1900, "none", True),
                ("128x128 causal", 64, 128, 128, "causal", False),
                ("96x128 padded", 64, 96, 128, "pad", False))


def _general_mask(torch, dev, tq, tk, kind):
    if kind == "causal":
        return torch.tril(torch.ones(tq, tk, dtype=torch.bool, device=dev))
    if kind == "pad":
        return (torch.arange(tk, device=dev) < tk - 28)[None, :].expand(
            tq, tk).contiguous()
    return torch.ones(tq, tk, dtype=torch.bool, device=dev)


def attn_bounds(p, tq, tk, self_attn, dropout, qkv=False):
    """{eval, saved, bwd}: (bound_ms, bound_by) of one attention call in
    bf16: every operand read once and every result written once, the
    products at the tensor cores' rate plus the Philox draws at the int32
    rate (`philox_s`).  qkv: the save-qkv policy's three more f32 [H, P*T, 64] arrays,
    written by the forward and read by the backward instead of the three
    projections."""
    d, dk, h = 512, 64, 8
    n_in = p * (tq if self_attn else tq + tk) * d * 2
    w_bytes = (3 * d * d + dk * h * dk + h * dk + dk * d) * 2 + 2 * d * 4
    oh_bytes = h * p * tq * dk * 4
    qkv_bytes = h * p * (tq + 2 * tk) * dk * 4 if qkv else 0
    seed = 8 if dropout else 0
    t_philox = (philox_s((h * p * tq * tk + p * tq * d) / 4)
                if dropout else 0.0)
    proj = p * (2 * tq * d * d + 4 * tk * d * d)
    flops_f = proj + p * (4 * tq * tk * d + 2 * dk * h * dk + 2 * tq * dk * d)
    # scores, dP, dv, dz, dk; fc, do, dfc; dxq, dxkv and the three
    # projection weight gradients; the projections again unless saved
    flops_b = (0 if qkv else proj) + p * (
        10 * tq * tk * d + 6 * tq * dk * d + 4 * tq * d * d + 8 * tk * d * d)
    eval_bytes = n_in + w_bytes + tq * tk + p * tq * d * 2
    specs = {"eval": (eval_bytes, flops_f),
             "saved": (eval_bytes + oh_bytes + qkv_bytes + seed, flops_f),
             "bwd": (n_in + w_bytes + oh_bytes + qkv_bytes + tq * tk + seed +
                     p * tq * d * 2 + p * (tq + tk) * d * 2 + w_bytes,
                     flops_b)}
    out = {}
    for k, (nbytes, flops) in specs.items():
        t_bytes = nbytes / HBM_BYTES_S * 1e3
        t_ops = (flops / BF16_FLOP_S + (t_philox if k != "eval" else 0)) * 1e3
        out[k] = (max(t_bytes, t_ops),
                  "bytes" if t_bytes >= t_ops else "operations")
    return out


def _attn_tols(torch, dtype):
    """(forward and saved-output tolerance, backward tolerance) of the
    attention checks, as the short kernel's."""
    if dtype == torch.float32:
        return F32_TOL, BWD_REL
    return 2.0 ** -5, BF16_BWD_REL


def _saved_err(torch, got, want, dtype):
    """f32: max abs error; bf16 inputs: in units of max(1, |plain|) (the
    plain version rounds q/k/v and the probabilities to bf16)."""
    diff = (got - want).abs()
    if dtype == torch.bfloat16:
        diff = diff / want.abs().clamp(min=1.0)
    return diff.max().item()


def kernel_name(key):
    """A profiler kernel key without its return type, namespaces, template
    arguments and parameters ("out_fwd<bf16>" for the bf16 instance)."""
    import re

    name = re.sub(r"^void |\(anonymous namespace\)::", "", key)
    tmpl = "<bf16>" if "__nv_bfloat16" in name.split("(")[0] else ""
    return re.split(r"[<(]", name, maxsplit=1)[0].split("::")[-1] + tmpl


def kernels_ms(fn, iters=10):
    """{kernel name: device ms a call} of the kernels fn launches."""
    out = {}
    for key, _, ms in device_kernels(fn, iters):
        name = kernel_name(key)
        out[name] = out.get(name, 0.0) + ms
    return out


def same_bits(torch, name, first, again):
    """Fail unless two calls gave bit-equal tensors."""
    for i, (a, b) in enumerate(zip(first, again)):
        if not torch.equal(a, b):
            fail(f"{name}: output {i} differs between two calls")


def check_attention_general(torch, dev):
    """csrc/sh_attention_general.cu against the plain versions: the eval
    forward, the saved-outputs forward and the backward, at keep_prob 1 and
    with dropout from a seed (the plain versions fed the masks that
    csrc/dropout.cu dumps for that seed; at the 65-128 token shapes also
    from operand masks), f32 and bf16; at the co-attention's shapes two
    calls of every mode bit-equal (the kernels sum across blocks in a fixed
    order); timed in bf16, by CUDA events around the wrappers and on the
    device kernel by kernel (torch.profiler)."""
    from ait_tpu_torch.ops import dropout_masks as dm, fused_attention as fa

    keys = ("fwd", "saved", "bwd", "drop_fwd", "drop_bwd")
    res = {k: _res() for k in keys}
    device = {k: {} for k in keys}
    for i, (name, p, tq, tk, kind, main) in enumerate(ATTN_GENERAL):
        if fa.kernel_regime(tq, tk) != "general":
            fail(f"{name}: {tq}x{tk} is not in the general regime")
        mask = _general_mask(torch, dev, tq, tk, kind)
        gen = torch.Generator(device="cpu").manual_seed(p + tq + tk)
        seed = _seed(torch, dev, 50 + i)
        ak, ok = dm.dropout_keep_masks(seed, p, tq, tk, 512, keep_prob=KEEP)
        with plain_path():
            pk, po = dm.dropout_keep_masks(seed, p, tq, tk, 512,
                                           keep_prob=KEEP)
        if not (torch.equal(ak, pk) and torch.equal(ok, po)):
            fail(f"mask dump {name}: not bit-equal to the plain stream")
        del pk, po
        fed = dict(attn_keep=ak, out_keep=ok, keep_prob=KEEP)
        sources = [("keep 1", {}, {}),
                   ("seed", dict(seed=seed, keep_prob=KEEP), fed)]
        if not main:
            sources.append(("operand masks", fed, fed))
        for dtype in (torch.float32, torch.bfloat16):
            tol, tol_bwd = _attn_tols(torch, dtype)
            long_bf16 = main and dtype == torch.bfloat16
            if long_bf16:
                tol_bwd = BF16_BWD_REL_LONG
            args = _attn_args(torch, dev, p, tq, tk, dtype, seed=tq + tk)
            got = fa.fused_sh_attention(*args, mask)
            if main:
                same_bits(torch, f"sh_attention general {name} {dtype}",
                          [got], [fa.fused_sh_attention(*args, mask)])
            err = err_of(got, fa.sh_attention_reference(*args, mask))
            if not (math.isfinite(err) and err <= tol):
                fail(f"sh_attention general {name} {dtype}: err {err} > {tol}")
            if dtype == torch.float32:
                res["fwd"][0].append(err)
            g = torch.randn((p, tq, 512), generator=gen).to(dev, dtype)
            line = [f"eval err {err:.3e}"]
            for source, drop, plain_drop in sources:
                out, oh = fa.fused_sh_attention_saved(*args, mask, **drop)
                if main:
                    same_bits(torch, f"sh_attention_saved general "
                              f"({source}) {name} {dtype}", (out, oh),
                              fa.fused_sh_attention_saved(*args, mask,
                                                          **drop))
                rout, roh = fa.sh_attention_saved_reference(*args, mask,
                                                            **plain_drop)
                e_out = err_of(out, rout)
                e_oh = _saved_err(torch, oh, roh, dtype)
                if not (e_out <= tol and e_oh <= tol):
                    fail(f"sh_attention_saved general ({source}) {name} "
                         f"{dtype}: out err {e_out}, saved err {e_oh} "
                         f"(tol {tol})")
                grads = fa.fused_sh_attention_bwd(*args, mask, oh, g, **drop)
                if main:
                    same_bits(torch, f"sh_attention_bwd general ({source}) "
                              f"{name} {dtype}", grads,
                              fa.fused_sh_attention_bwd(*args, mask, oh, g,
                                                        **drop))
                want = fa.sh_attention_bwd_reference(*args, mask, roh, g,
                                                     **plain_drop)
                e_bwd, abs_bwd = check_grads(
                    f"sh_attention_bwd general ({source}) {name} {dtype}",
                    grads, want, tol_bwd)
                if dtype == torch.float32:
                    fkey, bkey = (("saved", "bwd") if not drop else
                                  ("drop_fwd", "drop_bwd"))
                    res[fkey][0].append(max(e_out, e_oh))
                    res[bkey][0].append(abs_bwd)
                line.append(f"{source}: out {e_out:.3e} saved {e_oh:.3e} "
                            f"bwd rel {e_bwd:.3e} abs {abs_bwd:.3e}")
                if long_bf16:
                    want32 = fa.sh_attention_bwd_reference(
                        *(a.float() for a in args), mask, roh, g.float(),
                        **plain_drop)
                    e32, _ = check_grads(
                        f"sh_attention_bwd general ({source}) {name} bf16 "
                        "against the plain version in f32", grads, want32,
                        BF16_BWD_REL)
                    line.append(f"bwd rel against the f32 plain version "
                                f"{e32:.3e} (tol {BF16_BWD_REL})")
                    del want32
                del out, oh, rout, roh, grads, want
            if main:
                line.append("two calls bit-equal in every mode")
            log(f"sh_attention general {name} P={p} {tq}x{tk} {dtype} (tol "
                f"{tol}, bwd {tol_bwd}): " + "; ".join(line))
        # timed in bf16 (args, g: the last dtype's)
        drop = dict(seed=seed, keep_prob=KEEP)
        _, oh = fa.fused_sh_attention_saved(*args, mask)
        _, ohd = fa.fused_sh_attention_saved(*args, mask, **drop)
        runs = {
            "fwd": (lambda: fa.fused_sh_attention(*args, mask),
                    lambda: fa.sh_attention_reference(*args, mask)),
            "saved": (lambda: fa.fused_sh_attention_saved(*args, mask),
                      lambda: fa.sh_attention_saved_reference(*args, mask)),
            "bwd": (lambda: fa.fused_sh_attention_bwd(*args, mask, oh, g),
                    lambda: fa.sh_attention_bwd_reference(*args, mask, oh,
                                                          g)),
            "drop_fwd": (lambda: fa.fused_sh_attention_saved(*args, mask,
                                                             **drop),
                         lambda: fa.sh_attention_saved_reference(
                             *args, mask, **fed)),
            "drop_bwd": (lambda: fa.fused_sh_attention_bwd(*args, mask, ohd,
                                                           g, **drop),
                         lambda: fa.sh_attention_bwd_reference(
                             *args, mask, ohd, g, **fed))}
        bounds = {False: attn_bounds(p, tq, tk, tq == tk, False),
                  True: attn_bounds(p, tq, tk, tq == tk, True)}
        for k, (kernel, plain) in runs.items():
            ms = cuda_ms(kernel, iters=5)
            plain_ms = cuda_ms(plain, iters=3, warmup=1)
            per_kernel = kernels_ms(kernel)
            bkey = {"fwd": "eval", "saved": "saved", "drop_fwd": "saved"}.get(
                k, "bwd")
            t_bound, by = bounds[k.startswith("drop")][bkey]
            log(f"sh_attention general {k} {name}: kernel_ms {ms:.3f} "
                f"(device {sum(per_kernel.values()):.4f}: " +
                ", ".join(f"{n} {v:.4f}" for n, v in sorted(
                    per_kernel.items(), key=lambda kv: -kv[1])) +
                f") plain_ms {plain_ms:.3f} bound_ms {t_bound:.4f} ({by})")
            if main:
                for j, v in enumerate((ms, plain_ms, t_bound)):
                    res[k][j + 1] += v
                for n, v in per_kernel.items():
                    device[k][n] = device[k].get(n, 0.0) + v
        del ak, ok, fed, oh, ohd
    out = {k: _finish(v, "operations") for k, v in res.items()}
    for k in keys:   # the co-attention's two calls, on the device
        out[k]["device_ms"] = sum(device[k].values())
        out[k]["device_ms_by_kernel"] = device[k]
    return out


def check_save_qkv(torch, dev):
    """The save-qkv policy at the train path's shapes (and one 65-128 token
    shape of the general regime): the saved per-head q / 8, k, v against the
    plain version's, the gradients with and without bit for bit, the peak
    memory of a forward + backward both ways, and both timed in turns
    (bf16, dropout from a seed: the train path's form)."""
    from ait_tpu_torch.ops import fused_attention as fa

    res = {"fwd": _res(), "bwd": _res()}
    shapes = [(name, p, tq, tk, _attn_mask(torch, dev, tq, tk, sa), sa, True)
              for name, p, tq, tk, sa in ATTN_TRAIN]
    shapes.append(("128x128 causal", 64, 128, 128,
                   _general_mask(torch, dev, 128, 128, "causal"), True,
                   False))
    for i, (name, p, tq, tk, mask, self_attn, main) in enumerate(shapes):
        gen = torch.Generator(device="cpu").manual_seed(p + tq + 2)
        seed = _seed(torch, dev, 60 + i)
        drop = dict(seed=seed, keep_prob=KEEP)
        for dtype in (torch.float32, torch.bfloat16):
            args = _attn_args(torch, dev, p, tq, tk, dtype, seed=tq + tk)
            g = torch.randn((p, tq, 512), generator=gen).to(dev, dtype)
            out, oh, qkv = fa.fused_sh_attention_saved(*args, mask,
                                                       save_qkv=True, **drop)
            out0, oh0 = fa.fused_sh_attention_saved(*args, mask, **drop)
            if not (torch.equal(out, out0) and torch.equal(oh, oh0)):
                fail(f"save-qkv {name} {dtype}: the forward's results differ "
                     "with and without the saved q/k/v")
            want = fa.sh_attention_saved_reference(*args, mask,
                                                   save_qkv=True)[2]
            # bf16: the plain version rounds the projections to bf16 (and q
            # again after the scale), the kernel saves its f32 sums
            tol = F32_TOL if dtype == torch.float32 else 2.0 ** -6
            errs = [_saved_err(torch, a, b, dtype) for a, b in zip(qkv, want)]
            if not all(math.isfinite(e) and e <= tol for e in errs):
                fail(f"save-qkv {name} {dtype}: saved q/k/v errors {errs} "
                     f"(tol {tol})")
            with_qkv = fa.fused_sh_attention_bwd(*args, mask, oh, g, qkv=qkv,
                                                 **drop)
            without = fa.fused_sh_attention_bwd(*args, mask, oh, g, **drop)
            diffs = [(a.float() - b.float()).abs().max().item()
                     for a, b in zip(with_qkv, without)]
            if not all(torch.equal(a, b) for a, b in zip(with_qkv, without)):
                fail(f"save-qkv {name} {dtype}: gradients differ from the "
                     f"recompute's: max abs diffs {diffs}")
            if dtype == torch.float32:
                res["fwd"][0].append(max(errs))
                res["bwd"][0].append(max(diffs))
            log(f"save-qkv {name} P={p} {tq}x{tk} {dtype}: saved q/k/v errs "
                f"{[f'{e:.3e}' for e in errs]} (tol {tol}); 10 gradients "
                "bit-equal to the recompute's")
            del out, oh, qkv, out0, oh0, want, with_qkv, without

        def step(save):
            o = fa.fused_sh_attention_saved(*args, mask, save_qkv=save,
                                            **drop)
            return fa.fused_sh_attention_bwd(
                *args, mask, o[1], g, qkv=o[2] if save else None, **drop)

        peak = {}
        for save in (False, True):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            step(save)
            torch.cuda.synchronize()
            peak[save] = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 20
        o = fa.fused_sh_attention_saved(*args, mask, save_qkv=True, **drop)
        fwd = {s: (lambda s=s: fa.fused_sh_attention_saved(
            *args, mask, save_qkv=s, **drop)) for s in (False, True)}
        bwd = {s: (lambda s=s: fa.fused_sh_attention_bwd(
            *args, mask, o[1], g, qkv=o[2] if s else None, **drop))
            for s in (False, True)}
        t = {}
        for kind, fns in (("fwd", fwd), ("bwd", bwd)):
            # off, on, on, off
            a, b = cuda_ms(fns[False], iters=5), cuda_ms(fns[True], iters=5)
            c, d_ = cuda_ms(fns[True], iters=5), cuda_ms(fns[False], iters=5)
            t[kind] = ((a + d_) / 2, (b + c) / 2)
        plain_f = cuda_ms(lambda: fa.sh_attention_saved_reference(
            *args, mask, save_qkv=True, **drop), iters=3, warmup=1)
        plain_b = cuda_ms(lambda: fa.sh_attention_bwd_reference(
            *args, mask, o[1], g, **drop), iters=3, warmup=1)
        bounds = attn_bounds(p, tq, tk, self_attn, True, qkv=True)
        log(f"save-qkv {name} (bf16, seed dropout): forward {t['fwd'][1]:.3f} "
            f"ms with, {t['fwd'][0]:.3f} ms without; backward "
            f"{t['bwd'][1]:.3f} ms with, {t['bwd'][0]:.3f} ms without; peak "
            f"memory of forward + backward {peak[True]:.1f} MiB with, "
            f"{peak[False]:.1f} MiB without; plain_ms {plain_f:.3f} / "
            f"{plain_b:.3f}; bound_ms {bounds['saved'][0]:.4f} "
            f"({bounds['saved'][1]}) / {bounds['bwd'][0]:.4f} "
            f"({bounds['bwd'][1]})")
        if main:
            for key, vals in (("fwd", (t["fwd"][1], plain_f,
                                       bounds["saved"][0])),
                              ("bwd", (t["bwd"][1], plain_b,
                                       bounds["bwd"][0]))):
                for j, v in enumerate(vals):
                    res[key][j + 1] += v
        del o
    return {k: _finish(v, "operations") for k, v in res.items()}


# ------------------------------------------------------------------- gemm


def gemm_shapes():
    """csrc/gemm.cu's products in one default train step at B = 8, bf16:
    (name, layout, M, N, K, A dtype, B dtype, epilogue, out dtype, calls per
    step).  The FFN backward's six per call (ops/fused_ffn.py), the attention
    projections (three in each forward and each backward) and the attention
    backward's eight (ops/fused_attention.py; dxkv and dwk/dwv twice), and
    the long-sequence regime's projection (opt-in, 0 per default step)."""
    import torch

    from ait_tpu_torch.ops._gemm import NN, NT, TN

    bf, f32 = torch.bfloat16, torch.float32
    rows = []
    for tag, n in (("encoder", B * ROIS * 56), ("decoder", B * ROIS * 64)):
        rows += [(f"ffn y1 {tag}", NN, n, 2048, 512, bf, bf, "bias_relu", bf, 1),
                 (f"ffn y2 {tag}", NN, n, 512, 2048, bf, bf, "bias", f32, 1),
                 (f"ffn dy1 {tag}", NT, n, 2048, 512, bf, bf, "mask", f32, 1),
                 (f"ffn dx {tag}", NT, n, 512, 2048, bf, bf, "cadd", f32, 1),
                 (f"ffn dw1 {tag}", TN, 512, 2048, n, bf, f32, None, bf, 1),
                 (f"ffn dw2 {tag}", TN, 2048, 512, n, bf, f32, None, bf, 1)]
    for tag, p, tq, tk, _ in ATTN_TRAIN:
        mq, mk = p * tq, p * tk
        # the projections: q, k, v in the forward and again in the backward
        rows += [(f"attn proj q {tag}", NN, mq, 512, 512, bf, bf, None, f32, 2),
                 (f"attn proj kv {tag}", NN, mk, 512, 512, bf, bf, None, f32,
                  4)]
        rows += [(f"attn dxq {tag}", NT, mq, 512, 512, f32, bf, "cadd", f32, 1),
                 (f"attn dxkv {tag}", NT, mk, 512, 512, f32, bf, "cadd", f32, 2),
                 (f"attn dwq {tag}", TN, 512, 512, mq, bf, f32, None, bf, 1),
                 (f"attn dwkv {tag}", TN, 512, 512, mk, bf, f32, None, bf, 2),
                 (f"attn dfc_w {tag}", TN, 64, 512, mq, bf, f32, None, bf, 1),
                 (f"attn dsk_w {tag}", TN, 64, 512, p, f32, f32, None, bf, 1)]
    rows.append(("long-seq projection", NN, B * 1900, 512, 512, bf, bf, None,
                 f32, 0))
    return rows


def _gemm_library(torch, dev):
    """The yardstick for a bf16 x bf16 -> f32 product: torch.mm with
    out_dtype=float32 where this torch has it, else torch.matmul in bf16."""
    a = torch.ones(16, 16, dtype=torch.bfloat16, device=dev)
    try:
        torch.mm(a, a, out_dtype=torch.float32)
        return "torch.mm(out_dtype=float32)"
    except (TypeError, RuntimeError):
        return "torch.matmul in bf16"


def _cuobjdump(stem, *flags):
    import shutil

    from ait_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, *flags, _build.library_path(stem)],
                          capture_output=True, text=True, check=True).stdout


def hgmma_count(stem="gemm"):
    """HGMMA instructions in the built library of csrc/<stem>.cu."""
    return _cuobjdump(stem, "-sass").count("HGMMA")


def kernel_resources(stem):
    """{kernel: "REG:.. STACK:.. SHARED:.. LOCAL:.."} of the built library
    (cuobjdump's resource usage: registers a thread, the stack frame, where
    spills go, and static shared memory; the dynamic shared memory is the
    launcher's)."""
    res, name = {}, None
    for line in _cuobjdump(stem, "-res-usage").splitlines():
        line = line.strip()
        if line.startswith("Function "):
            name = line[len("Function "):].rstrip(":")
        elif name and line.startswith("REG:"):
            res[name] = " ".join(line.split()[:4])
    return res


def check_tensor_core_libraries():
    """The redesigned forwards' libraries issue wgmma (HGMMA in the SASS);
    logs every kernel's registers, stack (spills) and static shared memory,
    and fails where the FFN's tensor-core kernel spills: its accumulators
    take 160 registers, and spilling them serializes its wgmmas."""
    out = {}
    for stem in ("ffn", "sh_attention"):
        n = hgmma_count(stem)
        if n <= 0:
            fail(f"{stem}: no HGMMA instruction in the built library")
        for name, use in sorted(kernel_resources(stem).items()):
            log(f"{stem}: {name[:100]}: {use}")
            if "ffn_tc_kernel" in name and "STACK:0" not in use:
                fail(f"{stem}: {name} spills ({use})")
        log(f"{stem}: {n} HGMMA instructions in the library")
        out[stem] = n
    # the per-pair backward's per-head products, and every product of the
    # tiled kernels (csrc/sh_attention_general.cu): mma.sync (HMMA)
    for stem in ("sh_attention", "sh_attention_general"):
        out[f"{stem}_hmma"] = _cuobjdump(stem, "-sass").count("HMMA")
        if out[f"{stem}_hmma"] <= 0:
            fail(f"{stem}: no HMMA instruction in the built library")
        log(f"{stem}: {out[f'{stem}_hmma']} HMMA instructions in the "
            "library")
    for stem in ("sh_attention_general", "dropout"):
        for name, use in sorted(kernel_resources(stem).items()):
            log(f"{stem}: {name[:100]}: {use}")
    return out


def philox_instructions():
    """Instructions of one Philox4x32-10 call (`keep_group`) in the built
    posln library's SASS: `philox_probe_kernel` minus
    `philox_probe_base_kernel` (the same loads and stores around no call),
    each counted without its padding (NOP) and closing self-branch."""
    import re

    counts, name = {}, None
    for line in _cuobjdump("posln", "-sass").splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.match(r"\s*/\*[0-9a-f]{4}\*/\s+\S", line):
            op = line.split("*/", 1)[1].strip()
            if not op.startswith(("NOP", "BRA")):
                counts[name] += 1
    probe = [v for k, v in counts.items() if "philox_probe_kernel" in k]
    base = [v for k, v in counts.items() if "philox_probe_base_kernel" in k]
    if len(probe) != 1 or len(base) != 1 or probe[0] <= base[0]:
        fail(f"posln: no Philox probe kernels in the SASS ({counts})")
    return probe[0] - base[0]


def check_posln_library(torch):
    """Logs csrc/posln.cu's kernels' registers, stack and static shared
    memory; counts one Philox call's instructions in its SASS and sets the
    Philox bound term's rate (PHILOX): INT32_PER_CLOCK_SM x the SMs x the
    SM clock nvidia-smi reports (clocks.max.sm)."""
    for name, use in sorted(kernel_resources("posln").items()):
        log(f"posln: {name[:100]}: {use}")
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    PHILOX["instructions"] = philox_instructions()
    PHILOX["int32_ops_s"] = INT32_PER_CLOCK_SM * sms * mhz * 1e6
    log(f"Philox4x32-10: {PHILOX['instructions']} instructions a call (SASS);"
        f" int32 rate {INT32_PER_CLOCK_SM} x {sms} SMs x {mhz:g} MHz = "
        f"{PHILOX['int32_ops_s']:.4g} /s")


def check_gemm(torch, dev):
    """csrc/gemm.cu at every shape of the default train step: the kernel
    against `gemm_reference` (f32 outputs within 1e-4 of max |plain|, bf16
    within 8e-3: f32 summation order; an f32 operand's three bf16 terms are
    exact), split K bit-equal across two runs, and per shape its time, the
    plain version's, one PyTorch call's (library_ms: bf16 x bf16 as
    `_gemm_library` says, bf16 x f32 as torch.matmul in f32 on the operand
    cast beforehand, TF32 off) and the bound (2 M N K at 989 TFLOP/s, or each
    operand read and the output written once at 3.35 TB/s: the function's
    operations, so a product with an f32 operand, three bf16 products on the
    card, reaches at most a third of it).  Sums per step, FFN and attention
    apart; the FMA-tile products (f32 x f32, dsk_w) must take < 1 ms a
    step; the library's SASS must hold HGMMA."""
    from ait_tpu_torch.ops import _gemm

    hgmma = hgmma_count("gemm")
    if hgmma <= 0:
        fail("gemm: no HGMMA instruction in the built library")
    lib_form = _gemm_library(torch, dev)
    log(f"gemm: {hgmma} HGMMA instructions in the library; library_ms of "
        f"bf16 x bf16 is {lib_form}")
    gen = torch.Generator(device=dev).manual_seed(11)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bf = torch.bfloat16
    tot = {k: 0.0 for k in ("ms", "plain", "lib", "bound", "bound_ops")}
    part = {"ffn": 0.0, "attn": 0.0, "fma": 0.0}
    errs = []

    def rn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    for name, lay, m, n, k, adt, bdt, epi, odt, calls in gemm_shapes():
        a = rn(*((k, m) if lay == _gemm.TN else (m, k)), dtype=adt)
        b = rn(*((n, k) if lay == _gemm.NT else (k, n)), dtype=bdt)
        kw, extra = {"out_dtype": odt}, 0
        if epi in ("bias", "bias_relu"):
            kw.update(bias=rn(n), relu=epi == "bias_relu")
            extra = n * 4
        elif epi == "mask":
            kw["mask"] = rn(m, n, dtype=bf)
            extra = m * n * 2
        elif epi == "cadd":
            kw["cadd"] = rn(m, n)
            extra = m * n * 4
        got = _gemm.gemm(lay, a, b, **kw)
        want = _gemm.gemm_reference(lay, a, b, **kw)
        err = rel_err(got, want)
        tol = 8e-3 if odt == bf else 1e-4
        if not (math.isfinite(err) and err <= tol):
            fail(f"gemm {name}: err {err} of max |plain| (tol {tol})")
        if odt == torch.float32:
            errs.append((got.float() - want.float()).abs().max().item())
        tc = _gemm.tensor_core_path(a, b)
        splits = (_gemm.tc_splits(m, n, k, sms) if tc
                  else _gemm._fma_splits(lay, m, n, k))
        if splits > 1 and not torch.equal(got, _gemm.gemm(lay, a, b, **kw)):
            fail(f"gemm {name}: two split-K runs differ")
        at = a.t() if lay == _gemm.TN else a
        bt = b.t() if lay == _gemm.NT else b
        if adt == bdt == bf and lib_form.startswith("torch.mm"):
            lib = lambda: torch.mm(at, bt, out_dtype=torch.float32)  # noqa
        elif adt == bdt:
            lib = lambda: torch.matmul(at, bt)  # noqa: E731
        else:
            a32, b32 = at.float(), bt.float()
            lib = lambda: torch.matmul(a32, b32)  # noqa: E731
        ms = cuda_ms(lambda: _gemm.gemm(lay, a, b, **kw), iters=10)
        plain_ms = cuda_ms(lambda: _gemm.gemm_reference(lay, a, b, **kw),
                           iters=3, warmup=1)
        lib_ms = cuda_ms(lib, iters=10)
        nbytes = (a.numel() * a.element_size() + b.numel() * b.element_size()
                  + m * n * got.element_size() + extra)
        t_ops, t_bytes = 2 * m * n * k / BF16_FLOP_S * 1e3, nbytes / HBM_BYTES_S * 1e3
        t_bound = max(t_ops, t_bytes)
        log(f"gemm {name}: {'NN NT TN'.split()[lay]} M={m} N={n} K={k} "
            f"{str(adt)[6:]} x {str(bdt)[6:]} -> {str(odt)[6:]} "
            f"({'tensor cores' if tc else 'FMA tiles'}, {splits} split(s)), "
            f"{calls}/step: err {err:.3e} of max |plain|; kernel_ms {ms:.4f} "
            f"plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} bound_ms "
            f"{t_bound:.4f} ({'operations' if t_ops >= t_bytes else 'bytes'}"
            f"; {2 * m * n * k / ms / 1e9:.1f} TFLOP/s)")
        for key, v in (("ms", ms), ("plain", plain_ms), ("lib", lib_ms),
                       ("bound", t_bound),
                       ("bound_ops", t_bound if t_ops >= t_bytes else 0.0)):
            tot[key] += calls * v
        if calls:
            part[name.split()[0]] += calls * ms
            if not tc:
                part["fma"] += calls * ms
        del a, b, got, want, kw
    log(f"gemm per default train step (B = {B}, bf16): kernel {tot['ms']:.3f} "
        f"ms (FFN backward {part['ffn']:.3f}, attention backward "
        f"{part['attn']:.3f}, of which FMA tiles {part['fma']:.4f}); plain "
        f"{tot['plain']:.3f}, library {tot['lib']:.3f}, bound "
        f"{tot['bound']:.4f} ms")
    if not part["fma"] < 1.0:
        fail(f"gemm: the FMA-tile products take {part['fma']:.3f} ms a step "
             "(limit 1 ms)")
    by = "operations" if 2 * tot["bound_ops"] >= tot["bound"] else "bytes"
    return {"max_abs_err": max(errs), "ms": tot["ms"],
            "plain_ms": tot["plain"], "bound_ms": tot["bound"],
            "bound_by": by, "library_ms": tot["lib"]}


# ------------------------------------------------------------------ slice


def kernel_wrappers():
    """JSON name -> (the wrapper, its attribute that counts that kernel's
    launches).  A wrapper with a dropout form counts its keep_prob 1
    launches in `launches` and its dropout launches in `dropout_launches`."""
    from ait_tpu_torch.ops import (_gemm, dropout_masks as dm,
                                   fused_attention as fa, fused_ffn as ff,
                                   nms)

    return {"nms_keep_mask": (nms.nms_keep_mask_batched, "launches"),
            "sh_attention_fwd": (fa.fused_sh_attention, "launches"),
            "ffn_fwd": (ff.fused_ffn, "launches"),
            "posln_fwd": (ff.fused_posln, "launches"),
            "sh_attention_saved": (fa.fused_sh_attention_saved, "launches"),
            "sh_attention_bwd": (fa.fused_sh_attention_bwd, "launches"),
            "ffn_bwd": (ff.fused_ffn_bwd, "launches"),
            "posln_bwd": (ff.fused_posln_bwd, "launches"),
            # csrc/posln.cu `ln_bwd` inside the FFN backward (either form)
            "ln_bwd_ffn": (ff.fused_ffn_bwd, "ln_launches"),
            "sh_attention_drop_fwd": (fa.fused_sh_attention_saved,
                                      "dropout_launches"),
            "sh_attention_drop_bwd": (fa.fused_sh_attention_bwd,
                                      "dropout_launches"),
            "ffn_drop_fwd": (ff.fused_ffn, "dropout_launches"),
            "ffn_drop_bwd": (ff.fused_ffn_bwd, "dropout_launches"),
            "posln_drop_fwd": (ff.fused_posln, "dropout_launches"),
            "posln_drop_bwd": (ff.fused_posln_bwd, "dropout_launches"),
            "keep_mask_dump": (dm.keep_mask, "launches"),
            # the general regime (csrc/sh_attention_general.cu)
            "sh_attention_general_fwd": (fa.fused_sh_attention,
                                         "general_launches"),
            "sh_attention_general_saved": (fa.fused_sh_attention_saved,
                                           "general_launches"),
            "sh_attention_general_bwd": (fa.fused_sh_attention_bwd,
                                         "general_launches"),
            "sh_attention_general_drop_fwd": (fa.fused_sh_attention_saved,
                                              "general_dropout_launches"),
            "sh_attention_general_drop_bwd": (fa.fused_sh_attention_bwd,
                                              "general_dropout_launches"),
            # launches that also write / read the saved q/k/v
            "sh_attention_saveqkv_fwd": (fa.fused_sh_attention_saved,
                                         "qkv_launches"),
            "sh_attention_saveqkv_bwd": (fa.fused_sh_attention_bwd,
                                         "qkv_launches"),
            # the backward's products (csrc/gemm.cu): tensor cores, and the
            # FMA tiles of f32 x f32
            "gemm": (_gemm.gemm, "launches"),
            "gemm_fma": (_gemm.gemm, "fma_launches")}


# launches of each kernel per eval forward and per train step (a wrapper
# counts one launch per call, also where it runs several CUDA kernels); the
# default train step's dump launches are the co-attention's plain-path
# masks (2 per attention)
_DROP_KERNELS = ("sh_attention_drop_fwd", "sh_attention_drop_bwd",
                 "ffn_drop_fwd", "ffn_drop_bwd", "posln_drop_fwd",
                 "posln_drop_bwd", "keep_mask_dump")
# the opt-in policies' entries: 0 on every default path
_OPT_IN = ("sh_attention_general_fwd", "sh_attention_general_saved",
           "sh_attention_general_bwd", "sh_attention_general_drop_fwd",
           "sh_attention_general_drop_bwd", "sh_attention_saveqkv_fwd",
           "sh_attention_saveqkv_bwd")
_ZERO = dict.fromkeys(_DROP_KERNELS + _OPT_IN, 0)
# products: every attention forward makes its 3 projections on the tensor
# cores (both regimes), and every attention backward makes them again unless
# the forward saved q/k/v, then runs 7 more on the tensor cores and dsk_w
# (f32 x f32) on the FMA tiles; an FFN backward runs 6
ATTN_FWD_GEMM, ATTN_BWD_GEMM = 3, 3 + 7
GEMM_STEP = {"gemm": 2 * 6 + 3 * (ATTN_FWD_GEMM + ATTN_BWD_GEMM),
             "gemm_fma": 3}
PER_FORWARD = {**_ZERO, "nms_keep_mask": 2, "sh_attention_fwd": 3,
               "ffn_fwd": 2, "posln_fwd": 2, "sh_attention_saved": 0,
               "sh_attention_bwd": 0, "ffn_bwd": 0, "posln_bwd": 0,
               "ln_bwd_ffn": 0, "gemm": 3 * ATTN_FWD_GEMM, "gemm_fma": 0}
PER_STEP = {**_ZERO, "nms_keep_mask": 1, "sh_attention_fwd": 0, "ffn_fwd": 0,
            "posln_fwd": 0, "sh_attention_saved": 0, "sh_attention_bwd": 0,
            "ffn_bwd": 0, "posln_bwd": 0, "sh_attention_drop_fwd": 3,
            "sh_attention_drop_bwd": 3, "ffn_drop_fwd": 2, "ffn_drop_bwd": 2,
            "posln_drop_fwd": 2, "posln_drop_bwd": 2, "keep_mask_dump": 4,
            "ln_bwd_ffn": 2, **GEMM_STEP}
PER_STEP_NO_DROPOUT = {**_ZERO, "nms_keep_mask": 1, "sh_attention_fwd": 0,
                       "ffn_fwd": 2, "posln_fwd": 2, "sh_attention_saved": 3,
                       "sh_attention_bwd": 3, "ffn_bwd": 2, "posln_bwd": 2,
                       "ln_bwd_ffn": 2, **GEMM_STEP}
# _LONG_SEQ_FUSION on: the co-attention's two attentions go to the general
# regime (5 attention launches per forward) and draw seeds, so no mask dump;
# their products run on csrc/gemm.cu as the transformer's do
GEMM_STEP_LONG = {"gemm": GEMM_STEP["gemm"] +
                  2 * (ATTN_FWD_GEMM + ATTN_BWD_GEMM),
                  "gemm_fma": GEMM_STEP["gemm_fma"] + 2}
PER_FORWARD_LONG = {**PER_FORWARD, "sh_attention_general_fwd": 2,
                    "gemm": 5 * ATTN_FWD_GEMM}
PER_STEP_LONG = {**PER_STEP, "keep_mask_dump": 0,
                 "sh_attention_general_drop_fwd": 2,
                 "sh_attention_general_drop_bwd": 2, **GEMM_STEP_LONG}
PER_STEP_LONG_NO_DROPOUT = {**PER_STEP_NO_DROPOUT,
                            "sh_attention_general_saved": 2,
                            "sh_attention_general_bwd": 2, **GEMM_STEP_LONG}
# _SAVE_QKV on: the transformer's three attentions also save and read q/k/v,
# so their backward makes no projections
PER_STEP_SAVE_QKV = {**PER_STEP, "sh_attention_saveqkv_fwd": 3,
                     "sh_attention_saveqkv_bwd": 3,
                     "gemm": GEMM_STEP["gemm"] - 3 * ATTN_FWD_GEMM}
# accum_steps = 2: every kernel twice per optimizer step
PER_STEP_ACCUM_2 = {k: 2 * v for k, v in PER_STEP.items()}


@contextlib.contextmanager
def policies(long_seq=False, save_qkv=False):
    """The port's two opt-in kernel policies, as a caller turns them on: the
    module switches models.attention._LONG_SEQ_FUSION and
    ops.fused_attention._SAVE_QKV (restored on exit)."""
    from ait_tpu_torch.models import attention
    from ait_tpu_torch.ops import fused_attention

    saved = attention._LONG_SEQ_FUSION, fused_attention._SAVE_QKV
    attention._LONG_SEQ_FUSION = long_seq
    fused_attention._SAVE_QKV = save_qkv
    try:
        yield
    finally:
        attention._LONG_SEQ_FUSION, fused_attention._SAVE_QKV = saved


def zero_counts():
    for fn, attr in kernel_wrappers().values():
        setattr(fn, attr, 0)


def read_counts(expected, runs, what):
    launches = {k: getattr(fn, attr)
                for k, (fn, attr) in kernel_wrappers().items()}
    for k, n in expected.items():
        if launches[k] != n * runs:
            fail(f"{k}: {launches[k]} launches over {runs} {what}, "
                 f"expected {n} per {what[:-1]}")
    log(f"gemm per {what[:-1]}: {launches['gemm'] / runs:g} tensor-core "
        f"launches, {launches['gemm_fma'] / runs:g} FMA-tile launches")
    return launches


@contextlib.contextmanager
def plain_path():
    """Route every kernel wrapper to its plain version (to hold the whole
    kernel path against the plain path on the same card); the model and
    the autograd Functions look the wrappers up at call time."""
    from ait_tpu_torch.ops import (dropout_masks as dm, fused_attention as fa,
                                   fused_ffn as ff, nms, philox)

    swaps = [(fa, "fused_sh_attention", fa.sh_attention_reference),
             (fa, "fused_sh_attention_saved", fa.sh_attention_saved_reference),
             (fa, "fused_sh_attention_bwd", fa.sh_attention_bwd_reference),
             (ff, "fused_ffn", ff.ffn_reference),
             (ff, "fused_ffn_bwd", ff.ffn_bwd_reference),
             (ff, "fused_posln", ff.posln_reference),
             (ff, "fused_posln_bwd", ff.posln_bwd_reference),
             (nms, "nms_keep_mask_batched", nms.nms_keep_mask_reference),
             (dm, "keep_mask", philox.keep_mask)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    for m, n, f in swaps:
        setattr(m, n, f)
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def make_requests(np, cfg, rng, b):
    """b requests as a user sends them: canvases padded with the mean
    pixel (predict.CANVAS_FILL), query crops, im_info."""
    from ait_tpu_torch.predict import CANVAS_FILL

    h, w = cfg.tpu.image_size
    q = cfg.TRAIN.query_size
    canvas = np.empty((b, h, w, 3), np.uint8)
    canvas[:] = CANVAS_FILL
    im_info = np.zeros((b, 3), np.float32)
    for i in range(b):
        # an image resized to the 600 scale, placed top-left on the canvas
        ih, iw = 600, int(rng.randint(450, w + 1))
        canvas[i, :ih, :iw] = rng.randint(0, 256, (ih, iw, 3))
        im_info[i] = (ih, iw, 600.0 / 375.0)
    query = rng.randint(0, 256, (b, q, q, 3)).astype(np.uint8)
    return canvas, query, im_info


def make_weights(torch):
    """(cfg, the JAX-layout param tree from seed 0, its state dict)."""
    from ait_tpu_torch import bridge
    from ait_tpu_torch.config import Config
    from ait_tpu_torch.models import AITDetector

    cfg = Config()
    t0 = time.time()
    shapes = bridge.jax_shapes(AITDetector(cfg))
    params = bridge.random_tree(shapes, seed=0)
    state = bridge.to_state_dict(AITDetector(cfg), params)
    n_params = sum(v.numel() for v in state.values())
    log(f"weights: {n_params} parameters from seed 0 through the bridge "
        f"({time.time() - t0:.1f} s)")
    return cfg, params, state


def drive_slice(torch, np, dev, cfg, state, batches=BATCHES,
                per_forward=PER_FORWARD, what="default"):
    """One warm-up and `batches` timed batches of B requests through
    OneShotPredictor, under whatever policies the caller turned on."""
    from ait_tpu_torch.predict import OneShotPredictor

    predictor = OneShotPredictor(cfg, state, device=dev)
    rng = np.random.RandomState(0)
    requests = [make_requests(np, cfg, rng, B) for _ in range(batches + 1)]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    times = []
    for i, req in enumerate(requests):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dets = predictor.predict_prepared(*req)
        torch.cuda.synchronize()
        if i:                                   # the first is the warm-up
            times.append((time.perf_counter() - t0) * 1e3)
        check_dets(np, dets, req[2], cfg)
    launches = read_counts(per_forward, len(requests), "forwards")
    log(f"slice ({what}): {len(requests)} batches of {B} requests at "
        f"{cfg.tpu.image_size[0]}x{cfg.tpu.image_size[1]}; launches "
        f"{launches}")
    log(f"slice ({what}): ms per batch of {B} (after one warm-up): "
        f"{[round(t, 3) for t in times]}, mean {sum(times) / len(times):.3f}, "
        f"peak memory {torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} "
        "GiB")
    compare_paths(torch, np, cfg, state, dev, requests[0])
    return launches


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


def long_seq_on():
    from ait_tpu_torch.models import attention

    return attention._LONG_SEQ_FUSION


def with_coattention(torch, model, fn, feats=None):
    """(fn(), the co-attention's two outputs during it).  With `feats`,
    another run's outputs, the rest of the model sees those values while
    the gradients still flow into this run's co-attention.

    Under _LONG_SEQ_FUSION the co-attention, upstream of the proposal layer,
    differs between the kernel path and the plain path by f32 rounding, and
    a proposal score that moves by one ulp can reorder the top-N cut: the
    two paths would then head other rois and could not be compared.  So the
    co-attention's outputs are compared on their own, and everything after
    them runs on the kernel path's values on both paths."""

    class TakeValue(torch.autograd.Function):
        @staticmethod
        def forward(ctx, own, other):
            return other.clone()

        @staticmethod
        def backward(ctx, g):
            return g, None

    orig = model.coattention.forward
    seen = []

    def forward(*a, **k):
        out = orig(*a, **k)
        seen.append(tuple(t.detach() for t in out))
        if feats is None:
            return out
        return tuple(TakeValue.apply(o, f) for o, f in zip(out, feats))

    model.coattention.forward = forward
    try:
        res = fn()
    finally:
        del model.coattention.forward
    return res, seen[0]


def check_coattention_feats(got, want, what):
    """The co-attention's outputs, kernel path against plain path (f32):
    within 1e-4 of max |plain| (the kernels' f32 errors are ~1e-6)."""
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    log(f"{what}: co-attention outputs, kernel path vs plain path: "
        f"{[f'{e:.3e}' for e in errs]} of max |plain| (tol 1e-4)")
    if not all(math.isfinite(e) and e <= 1e-4 for e in errs):
        fail(f"{what}: the fused co-attention disagrees with the plain path: "
             f"{errs}")


def compare_paths(torch, np, cfg, state, dev, req):
    """The kernel path against the plain path, float32, TF32 off, 2 pairs
    (under _LONG_SEQ_FUSION: see `with_coattention`)."""
    from ait_tpu_torch.models import AITDetector

    model = AITDetector(cfg, dtype=torch.float32)
    model.load_state_dict(state)
    model.to(dev).eval()
    image, query, im_info = (torch.from_numpy(a[:2]).to(dev) for a in req)
    with torch.inference_mode():
        got, feats = with_coattention(
            torch, model, lambda: model(image, query, im_info))
        with plain_path():
            want, pfeats = with_coattention(
                torch, model, lambda: model(image, query, im_info),
                feats if long_seq_on() else None)
    torch.cuda.synchronize()
    if long_seq_on():
        check_coattention_feats(feats, pfeats, "eval (f32, 2 pairs)")
    diffs = {k: (getattr(got, k) - getattr(want, k)).abs().max().item()
             for k in ("rois", "cls_prob", "bbox_pred")}
    # upstream of the proposal layer both runs are the same ops, and the NMS
    # kernel bit-equals its plain version: identical rois; downstream the
    # f32 kernels (<= 2e-3 each, ~1e-5 measured) feed SKNet, layer4 and the
    # heads, which may amplify by a few times
    tol = {"rois": 0.0, "cls_prob": 1e-2, "bbox_pred": 1e-2}
    log(f"kernel path vs plain path (f32, 2 pairs on "
        f"{tuple(image.shape[1:])}): max abs diffs {diffs}")
    for k, v in diffs.items():
        if not math.isfinite(v) or v > tol[k]:
            fail(f"kernel path disagrees with the plain path on {k}: "
                 f"{v} > {tol[k]}")


# ------------------------------------------------------------ train slice

LOSS_FIELDS = ("rpn_loss_cls", "rpn_loss_box", "rcnn_loss_cls",
               "margin_loss", "rcnn_loss_bbox")
LOSS_KEYS = ("rpn_cls", "rpn_box", "rcnn_cls", "margin", "rcnn_box")


def train_config(t_dropout=None):
    """The flagship as `Config()` trains it, or at another t_dropout."""
    from ait_tpu_torch.config import Config

    cfg = Config()
    if t_dropout is None:
        return cfg
    return cfg.replace(model=dataclasses.replace(cfg.model,
                                                 t_dropout=t_dropout))


def make_train_batch(np, cfg, rng, b):
    """Requests as served, with 1-4 ground-truth boxes of class 1 per image
    (canvas coordinates, inside the image), zero-padded to MAX_NUM_GT_BOXES."""
    canvas, query, im_info = make_requests(np, cfg, rng, b)
    gt = np.zeros((b, cfg.MAX_NUM_GT_BOXES, 5), np.float32)
    for i in range(b):
        ih, iw = im_info[i, :2]
        for j in range(rng.randint(1, 5)):
            w, h = rng.uniform(48, iw / 2), rng.uniform(48, ih / 2)
            x1, y1 = rng.uniform(0, iw - w - 1), rng.uniform(0, ih - h - 1)
            gt[i, j] = (x1, y1, x1 + w, y1 + h, 1)
    return {"image": canvas, "query": query, "im_info": im_info,
            "gt_boxes": gt}


def drive_train(torch, np, dev, params, cfg, steps, per_step, *, what=None,
                accum_steps=1, optimizer="sgd", clip_norm=None, lr=None,
                compare=True, batches=None):
    """One warm-up and `steps` timed train steps of the full-width
    flagship in bf16 at a batch of B images, under whatever policies the
    caller turned on; per_step: the launches each kernel must show per
    step; batches: steps + 1 batches or more (default: synthetic requests
    with boxes)."""
    from ait_tpu_torch import bridge
    from ait_tpu_torch.models import AITDetector
    from ait_tpu_torch.train import (lr_schedule, make_optimizer,
                                     make_train_step)

    t = cfg.TRAIN
    what = f"t_dropout {cfg.model.t_dropout}" + (f", {what}" if what else "")
    model = AITDetector(cfg, dtype=torch.bfloat16)
    model.load_state_dict(bridge.to_state_dict(model, params))
    opt = make_optimizer(cfg, model, optimizer=optimizer, clip_norm=clip_norm)
    step = make_train_step(model, opt,
                           lr_schedule(lr or t.LEARNING_RATE, 1000, 5,
                                       t.GAMMA),
                           device=dev, accum_steps=accum_steps)
    trainable = {id(p) for g in opt.param_groups for p in g["params"]}
    names = {k for k, p in model.named_parameters() if id(p) in trainable}
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    if batches is None:
        rng = np.random.RandomState(1)
        batches = [make_train_batch(np, cfg, rng, B)
                   for _ in range(steps + 1)]
    gen = torch.Generator(device=dev).manual_seed(0)

    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    times = []
    for i, batch in zip(range(steps + 1), batches):
        if i == 0:
            first = batch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        met = step(batch, gen)
        torch.cuda.synchronize()
        if i:                                   # the first is the warm-up
            times.append((time.perf_counter() - t0) * 1e3)
        met = {k: float(v) for k, v in met.items()}
        if not all(math.isfinite(met[k]) for k in LOSS_KEYS + ("loss",)):
            fail(f"train step {i}: non-finite loss {met}")
        if met["fg_cnt"] + met["bg_cnt"] != B * t.BATCH_SIZE:
            fail(f"train step {i}: {met['fg_cnt']} + {met['bg_cnt']} "
                 f"sampled rois, expected {B * t.BATCH_SIZE}")
        log(f"train ({what}) step {i} on {tuple(batch['image'].shape)}: "
            f"{met}")
    if len(times) != steps:
        fail(f"train ({what}): {len(times) + 1} batches for {steps + 1} "
             "steps")
    launches = read_counts(per_step, steps + 1, "steps")
    after = model.state_dict()
    still = sorted(k for k in names if torch.equal(before[k], after[k]))
    moved = sorted(k for k in before
                   if k not in names and not torch.equal(before[k], after[k]))
    if still:
        fail(f"trainable leaves that did not move: {still[:10]}")
    if moved:
        fail(f"frozen leaves or buffers that moved: {moved[:10]}")
    mean = sum(times) / len(times)
    log(f"train ({what}): {steps + 1} steps of {B} images at "
        f"{cfg.tpu.image_size[0]}x{cfg.tpu.image_size[1]}, {ROIS} rois "
        f"each; launches {launches}; {len(names)} trainable leaves moved, "
        f"{len(before) - len(names)} frozen leaves and buffers unchanged")
    log(f"train ({what}): ms per step of {B} (after one warm-up): "
        f"{[round(x, 3) for x in times]}, mean {mean:.3f}, pairs/s "
        f"{B * 1e3 / mean:.2f}, peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")
    del model, opt, step
    if compare:
        compare_train_paths(torch, dev, cfg, params, first)
    return launches


def time_coattention(torch, np, dev, cfg, state):
    """The co-attention's two attentions at a batch of B, eval, bf16: the
    fused long-sequence regime against the plain path (cuBLAS products), in
    turns in one process: off, on, on, off."""
    from ait_tpu_torch.models import AITDetector

    model = AITDetector(cfg, dtype=torch.bfloat16)
    model.load_state_dict(state)
    model.to(dev).eval()
    co = model.coattention
    g = torch.Generator(device="cpu").manual_seed(9)
    img = torch.randn(B, 1900, 512, generator=g).to(dev, torch.bfloat16)
    qry = torch.randn(B, 64, 512, generator=g).to(dev, torch.bfloat16)

    def both():
        co.q2i_attn(img, qry, qry)
        co.i2q_attn(qry, img, img)

    times = []
    with torch.inference_mode():
        for on in (False, True, True, False):
            with policies(long_seq=on):
                times.append(cuda_ms(both, iters=10))
    fused, plain = (times[1] + times[2]) / 2, (times[0] + times[3]) / 2
    log(f"co-attention q2i + i2q, eval, bf16, B={B}: fused {fused:.3f} ms "
        f"(runs {times[1]:.3f}, {times[2]:.3f}), plain path {plain:.3f} ms "
        f"(runs {times[0]:.3f}, {times[3]:.3f})")
    return fused, plain


def compare_train_paths(torch, dev, cfg, params, batch):
    """One f32 train step (forward, losses, backward) of the kernel path
    against the plain path, at 2 images, same weights and draws (the
    generator's seed, so the same sampling and the same dropout masks: the
    kernels' in-kernel Philox masks on one path, ops/philox.py's on the
    other), TF32 off."""
    from ait_tpu_torch import bridge
    from ait_tpu_torch.models import AITDetector

    runs = []
    feats = None
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for plain in (False, True):
            model = AITDetector(cfg, dtype=torch.float32)
            model.load_state_dict(bridge.to_state_dict(model, params))
            model.to(dev).train()
            b2 = {k: torch.as_tensor(v[:2]).to(dev) for k, v in batch.items()}
            gen = torch.Generator(device=dev).manual_seed(7)
            with plain_path() if plain else contextlib.nullcontext():
                out, seen = with_coattention(
                    torch, model, lambda: model(
                        b2["image"], b2["query"], b2["im_info"],
                        b2["gt_boxes"], train=True, generator=gen),
                    feats if plain and long_seq_on() else None)
                out.total_loss.backward()
            if plain and long_seq_on():
                check_coattention_feats(feats, seen, "train (f32, 2 images)")
            feats = seen
            runs.append(([getattr(out, k).item() for k in LOSS_FIELDS],
                         out.rois_label,
                         {k: p.grad for k, p in model.named_parameters()
                          if p.grad is not None}))
            del model, out
    finally:
        torch.backends.cudnn.deterministic = det
    (lk, labk, gk), (lp, labp, gp) = runs
    if not torch.equal(labk, labp):
        fail("train step: the kernel and plain paths sampled other rois")
    loss_err = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lk, lp))
    if sorted(gk) != sorted(gp):
        fail("train step: the two paths give gradients to other leaves")
    grad_err = {k: rel_err(gk[k], gp[k]) for k in gp}
    worst = max(grad_err, key=grad_err.get)
    log(f"train kernel path vs plain path (f32, 2 images, t_dropout "
        f"{cfg.model.t_dropout}): losses {lk} vs {lp}, max rel diff "
        f"{loss_err:.3e}; {len(gp)} gradients, max diff "
        f"{grad_err[worst]:.3e} of the leaf's max |plain| ({worst})")
    if not loss_err <= 1e-4:
        fail(f"train step: losses differ by {loss_err} relative (tol 1e-4)")
    bad = {k: v for k, v in grad_err.items() if not v <= BWD_REL}
    if bad:
        fail(f"train step: gradients beyond {BWD_REL} of their leaf's max "
             f"|plain|: {sorted(bad.items(), key=lambda kv: -kv[1])[:10]}")

# -------------------------------------------------------------- data path

# a devkit's images: (height, width, count) landscape on the 608x800 canvas,
# portrait on its transpose, and wide ones (aspect 1.8) that need the
# 608x1216 bucket
DATA_SHAPES = ((375, 500, 10), (500, 375, 7), (330, 600, 7))
DATA_CANVASES = {(304, 400, 12), (400, 304, 12), (304, 608, 12)}
# the first box of an image is of a class evaluated here (the one-shot
# split seen=2: cow, sheep, cat, aeroplane), the second of a class trained
# on (seen=1), the rest of either
DATA_UNSEEN = ("cow", "sheep", "cat", "aeroplane")
DATA_SEEN = ("dog", "person", "car", "bus")
# f32, TF32 off: the stem's 4x4 convolution over 12 planes against the
# 7x7/2 over 3 on the same canvas (the same 147 products summed in another
# order) within STEM_REL of max |3-channel|; the backbone's features after
# it within BACKBONE_REL
STEM_REL, BACKBONE_REL = 1e-5, 1e-4


def write_devkit(np, root):
    """A VOC-layout devkit under root: VOC2007/Annotations/*.xml and
    ImageSets/Main/{test,trainval}.txt, 2-4 boxes an image; no image files.
    Returns (devkit, imread): imread serves each image's pixels, made from
    seed 0 (noise, a flat patch in each box), so no decoder is needed."""
    import xml.etree.ElementTree as ET

    rng = np.random.RandomState(0)
    base = os.path.join(root, "VOC2007")
    for sub in ("Annotations", "JPEGImages", os.path.join("ImageSets",
                                                          "Main")):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    pixels, names = {}, []
    for h, w, count in DATA_SHAPES:
        for _ in range(count):
            name = f"{len(names):06d}"
            im = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            ann = ET.Element("annotation")
            size = ET.SubElement(ann, "size")
            for tag, v in (("width", w), ("height", h), ("depth", 3)):
                ET.SubElement(size, tag).text = str(v)
            n = rng.randint(2, 5)
            for j in range(n):
                cls = (DATA_UNSEEN[len(names) % 4] if j == 0 else
                       DATA_SEEN[rng.randint(4)] if j == 1 else
                       (DATA_UNSEEN + DATA_SEEN)[rng.randint(8)])
                bw = rng.randint(w // 6, w // 2)
                bh = rng.randint(h // 6, h // 2)
                x1, y1 = rng.randint(1, w - bw), rng.randint(1, h - bh)
                im[y1:y1 + bh, x1:x1 + bw] = rng.randint(0, 256, 3)
                obj = ET.SubElement(ann, "object")
                ET.SubElement(obj, "name").text = cls
                ET.SubElement(obj, "difficult").text = "0"
                bb = ET.SubElement(obj, "bndbox")
                for tag, v in (("xmin", x1), ("ymin", y1),
                               ("xmax", x1 + bw), ("ymax", y1 + bh)):
                    ET.SubElement(bb, tag).text = str(v)
            ET.ElementTree(ann).write(
                os.path.join(base, "Annotations", name + ".xml"))
            pixels[os.path.join(base, "JPEGImages", name + ".jpg")] = im
            names.append(name)
    for split in ("test", "trainval"):
        with open(os.path.join(base, "ImageSets", "Main", split + ".txt"),
                  "w") as f:
            f.write("\n".join(names) + "\n")
    return root, pixels.__getitem__


def depth_to_space(np, x):
    """[B, H/2, W/2, 12] -> [B, H, W, 3], the inverse of space_to_depth."""
    b, h2, w2, _ = x.shape
    return np.ascontiguousarray(x.reshape(b, h2, w2, 2, 2, 3).transpose(
        0, 1, 3, 2, 4, 5)).reshape(b, 2 * h2, 2 * w2, 3)


def check_stem(torch, np, dev, state, cfg, image12):
    """The 12-plane stem against the 7x7/2 stem on the same canvas (f32,
    TF32 off), then both stems' device time at B = 8 in bf16, in turns
    (3, 12, 12, 3 planes).  Returns (ms 3-plane, ms 12-plane)."""
    from ait_tpu_torch.models import AITDetector
    from ait_tpu_torch.models.detector import _to_model_input
    from ait_tpu_torch.models.layers import to_nchw

    image3 = depth_to_space(np, image12)
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = AITDetector(cfg, dtype=dtype)
        model.load_state_dict(state)
        bb = model.backbone.to(dev).eval()
        x3, x12 = (to_nchw(_to_model_input(torch.from_numpy(a).to(dev),
                                           dtype)) for a in (image3, image12))
        with torch.inference_mode():
            if dtype == torch.float32:
                y3, y12 = bb.stem(x3[:2]), bb.stem(x12[:2])
                stem_err = rel_err(y12, y3)
                f3 = bb(_to_model_input(torch.from_numpy(image3[:2]).to(dev),
                                        dtype))
                f12 = bb(_to_model_input(
                    torch.from_numpy(image12[:2]).to(dev), dtype))
                feat_err = rel_err(f12, f3)
                log(f"data path: stem, 12 planes vs 3 (f32, TF32 off, 2 "
                    f"canvases {image3.shape[1]}x{image3.shape[2]}): "
                    f"{stem_err:.3e} of max |3-plane| (tol {STEM_REL}); "
                    f"backbone features {feat_err:.3e} (tol {BACKBONE_REL})")
                if not (stem_err <= STEM_REL and feat_err <= BACKBONE_REL):
                    fail(f"the 12-plane stem disagrees with the 3-plane "
                         f"stem: {stem_err}, features {feat_err}")
                continue
            for planes, x in ((3, x3), (12, x12), (12, x12), (3, x3)):
                times.setdefault(planes, []).append(
                    device_ms(lambda: bb.stem(x), iters=10))
    ms = {k: sum(v) / len(v) for k, v in times.items()}
    log(f"data path: stem device ms, bf16, B={image12.shape[0]}, "
        f"{image3.shape[1]}x{image3.shape[2]}: 7x7/2 over 3 planes "
        f"{ms[3]:.4f} (runs {times[3]}), 4x4/1 over 12 planes {ms[12]:.4f} "
        f"(runs {times[12]})")
    return ms[3], ms[12]


def time_h2d(torch, dev, batch):
    """ms to copy one batch's arrays to the card: from pinned memory
    (non_blocking) and from pageable memory; and the host ms of the copy
    into pinned memory that device_prefetch makes first."""
    host = {k: torch.from_numpy(v) for k, v in batch.items()}
    t0 = time.perf_counter()
    for _ in range(10):
        pinned = {k: v.pin_memory() for k, v in host.items()}
    pin_ms = (time.perf_counter() - t0) * 1e2
    ms = {"pinned": cuda_ms(lambda: [v.to(dev, non_blocking=True)
                                     for v in pinned.values()]),
          "pageable": cuda_ms(lambda: [v.to(dev) for v in host.values()])}
    nbytes = sum(v.numel() * v.element_size() for v in host.values())
    log(f"data path: H2D of one batch ({nbytes / 2 ** 20:.2f} MiB): pinned "
        f"{ms['pinned']:.4f} ms, pageable {ms['pageable']:.4f} ms; host copy "
        f"into pinned memory {pin_ms:.4f} ms")
    return ms


def drive_data_eval(torch, np, dev, cfg, state, view, imread):
    """The eval path from raw images: OneShotLoader (Config() unchanged:
    608x800 and its buckets, uint8, host space-to-depth) -> device_prefetch
    -> the flagship's eval step on the kernel path -> postprocess ->
    all_boxes (as tools/test_net.py fills it) -> evaluate_voc.  Every batch
    is checked: its canvas, its launches (PER_FORWARD), its detections, the
    prefetched tensors bit-equal to the host arrays.  Then the epoch runs 3
    times over, timed end to end.  Returns the checked pass's launches and
    the first batch of each canvas."""
    from ait_tpu_torch.data import OneShotLoader, device_prefetch
    from ait_tpu_torch.data.voc import class_order, split_classes
    from ait_tpu_torch.evaluation import evaluate_voc, postprocess_detections
    from ait_tpu_torch.models import AITDetector
    from ait_tpu_torch.train import make_eval_step

    model = AITDetector(cfg, dtype=torch.bfloat16)
    model.load_state_dict(state)
    model.to(dev).eval()
    step = make_eval_step(model)
    t = cfg.TEST
    inds = split_classes(2)

    def epoch(loader, check, repeat=1):
        all_boxes = {ci: {} for ci in inds}
        launches, shapes, host, walls = None, [], [], []

        def keep(batches):
            for b in batches:
                host.append(b)
                yield b

        t0 = time.perf_counter()
        batches = itertools.chain.from_iterable(
            loader.test_epoch(B) for _ in range(repeat))
        for batch in device_prefetch(keep(batches), size=2, device=dev):
            tb = time.perf_counter()
            if check:
                zero_counts()
            out = step(batch)
            dets, valid = postprocess_detections(
                out["rois"], out["cls_prob"], out["bbox_pred"],
                batch["im_info"], nms_thresh=t.NMS, score_thresh=0.0,
                max_per_image=t.MAX_PER_IMAGE,
                bbox_normalize_means=cfg.TRAIN.BBOX_NORMALIZE_MEANS,
                bbox_normalize_stds=cfg.TRAIN.BBOX_NORMALIZE_STDS)
            dets, valid = dets.cpu().numpy(), valid.cpu().numpy()
            walls.append((time.perf_counter() - tb) * 1e3)
            hb = host[len(walls) - 1]
            for i in range(len(hb["pair_index"])):
                all_boxes[int(hb["category"][i])][
                    int(hb["record_index"][i])] = dets[i][valid[i]]
            if not check:
                continue
            n = read_counts(PER_FORWARD, 1, "forwards")
            launches = n if launches is None else {
                k: launches[k] + n[k] for k in n}
            shapes.append(tuple(batch["image"].shape[1:]))
            for k, v in batch.items():
                if not np.array_equal(v.cpu().numpy(), hb[k]):
                    fail(f"device_prefetch changed the batch's {k}")
            check_dets(np, [d[m] for d, m in zip(dets, valid)],
                       hb["im_info"], cfg)
        wall = time.perf_counter() - t0
        return all_boxes, launches, shapes, host, walls, wall

    loader = OneShotLoader(view, cfg, training=False, imread=imread)
    all_boxes, launches, shapes, host, walls, _ = epoch(loader, True)
    if set(shapes) != DATA_CANVASES or \
            any(s[0] != B for s in (b["image"].shape for b in host)):
        fail(f"data path: batches {[b['image'].shape for b in host]}, "
             f"expected batches of {B} on {sorted(DATA_CANVASES)}")
    log(f"data path: {len(loader.pairs)} pairs of {len(view.records)} "
        f"images in {len(host)} batches of {B}, canvases "
        f"{[b['image'].shape[1:] for b in host]}; launches per forward as "
        f"expected in every batch: {launches}")
    res = evaluate_voc(all_boxes, view.records, inds, class_order(2))
    if not all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in res.values()):
        fail(f"data path: VOC AP out of [0, 1]: {res}")
    gt = {ci: {i: np.concatenate(
        [r.boxes[r.gt_classes == ci],
         np.ones((int((r.gt_classes == ci).sum()), 1), np.float32)], 1)
        for i, r in enumerate(view.records)} for ci in inds}
    res_gt = evaluate_voc(gt, view.records, inds, class_order(2))
    if not all(abs(v - 1.0) < 1e-12 for v in res_gt.values()):
        fail(f"data path: the ground truth as detections scores {res_gt}")
    log(f"data path: VOC07 AP of the random-weight flagship {res}; of the "
        f"ground truth as detections {res_gt}")

    # the same epoch 3 times over, timed: raw arrays to detections
    loader = OneShotLoader(view, cfg, training=False, imread=imread)
    *_, walls, wall = epoch(loader, False, repeat=3)
    pairs = 3 * len(loader.pairs)
    log(f"data path: eval end to end (loader, prefetch, forward, "
        f"postprocess), the epoch 3 times: {pairs} pairs in "
        f"{wall * 1e3:.3f} ms, {pairs / wall:.2f} pairs/s; ms per batch "
        f"from its arrival on the card to its detections on the host "
        f"{walls}")
    t0 = time.perf_counter()
    n = sum(1 for _ in loader.test_epoch(B))
    log(f"data path: host loader alone, eval: "
        f"{(time.perf_counter() - t0) * 1e3 / n:.3f} ms a batch of {B} "
        f"({n} batches, 8 worker threads)")
    firsts = {}
    for b in host:
        firsts.setdefault(b["image"].shape[1:], b)
    return launches, firsts


def drive_data_path(torch, np, dev, cfg, params, state):
    """Raw VOC-layout images in, AP out, on the kernel path; then training
    from the loader.  Returns the launches of each path."""
    import tempfile

    from ait_tpu_torch.data import OneShotLoader, device_prefetch
    from ait_tpu_torch.data.voc import filter_seen, load_voc

    t0 = time.time()
    with tempfile.TemporaryDirectory() as root:
        devkit, imread = write_devkit(np, root)
        test = filter_seen(load_voc(devkit, "2007", "test"), 2)
        train = filter_seen(load_voc(devkit, "2007", "trainval"), 1)
    paths = {}
    paths["data_eval"], firsts = drive_data_eval(torch, np, dev, cfg, state,
                                                 test, imread)
    batch = firsts[(304, 400, 12)]
    check_stem(torch, np, dev, state, cfg, batch["image"])
    time_h2d(torch, dev, batch)
    for b in firsts.values():
        compare_paths(torch, np, cfg, state, dev,
                      (b["image"], b["query"], b["im_info"]))
    # two steps (Config() unchanged: t_dropout 0.1) from the train loader
    loader = OneShotLoader(train, cfg, training=True, imread=imread)
    epoch = loader.train_epoch(B)
    try:
        paths["data_train"] = drive_train(
            torch, np, dev, params, cfg, 1, PER_STEP, what="from the loader",
            compare=False, batches=device_prefetch(epoch, device=dev))
    finally:
        epoch.close()
    t1 = time.perf_counter()
    n = sum(1 for _, _ in zip(range(4), loader.train_epoch(B)))
    log(f"data path: host loader alone, train: "
        f"{(time.perf_counter() - t1) * 1e3 / n:.3f} ms a batch of {B}")
    log(f"data path: {time.time() - t0:.1f} s")
    return paths


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
    sources = ["nms", "sh_attention", "sh_attention_general", "ffn", "posln",
               "gemm", "dropout"]
    _build.build_all(sources)
    log(f"built {sources} in {time.time() - t0:.1f} s")
    check_posln_library(torch)

    results = {"nms_keep_mask": check_nms(torch, dev, NMS_EVAL + NMS_TRAIN),
               "sh_attention_fwd": check_attention(torch, dev),
               "ffn_fwd": check_ffn(torch, dev),
               "posln_fwd": check_posln(torch, dev)}
    attn = check_attention_train(torch, dev)
    attn["bwd"].update(check_bwd_pairs(torch, dev))
    results.update({"sh_attention_saved": attn["saved"],
                    "sh_attention_bwd": attn["bwd"],
                    "ffn_bwd": check_ffn_train(torch, dev),
                    "posln_bwd": check_posln_train(torch, dev),
                    "ln_bwd_ffn": check_ffn_ln_bwd(torch, dev)})
    results["keep_mask_dump"] = check_masks(torch, dev)
    attn = check_attention_dropout(torch, dev)
    rows = check_rows_dropout(torch, dev)
    results.update({"sh_attention_drop_fwd": attn["fwd"],
                    "sh_attention_drop_bwd": attn["bwd"],
                    **{f"{k.split('_')[0]}_drop_{k.split('_')[1]}": v
                       for k, v in rows.items()}})
    gen = check_attention_general(torch, dev)
    results.update({f"sh_attention_general_{k}": v for k, v in gen.items()})
    qkv = check_save_qkv(torch, dev)
    results.update({f"sh_attention_saveqkv_{k}": v for k, v in qkv.items()})
    results["gemm"] = check_gemm(torch, dev)
    hgmma = check_tensor_core_libraries()
    for key, err in check_forward_modes(torch, dev).items():
        results[key]["max_abs_err"] = max(results[key]["max_abs_err"], err)
    results["sh_attention_fwd"]["hgmma"] = hgmma["sh_attention"]
    results["sh_attention_bwd"]["hmma"] = hgmma["sh_attention_hmma"]
    for k in ("fwd", "saved", "bwd", "drop_fwd", "drop_bwd"):
        results[f"sh_attention_general_{k}"]["hmma"] = hgmma[
            "sh_attention_general_hmma"]
    results["ffn_fwd"]["hgmma"] = hgmma["ffn"]

    cfg, params, state = make_weights(torch)
    paths = {"eval": drive_slice(torch, np, dev, cfg, state)}
    paths["train"] = drive_train(torch, np, dev, params, train_config(),
                                 STEPS, PER_STEP)
    paths["train_t_dropout_0"] = drive_train(
        torch, np, dev, params, train_config(0.0), 1, PER_STEP_NO_DROPOUT)
    # the two opt-in kernel policies, the accumulation and the other optimizer
    with policies(long_seq=True):
        paths["eval_long_seq"] = drive_slice(
            torch, np, dev, cfg, state, 1, PER_FORWARD_LONG,
            "_LONG_SEQ_FUSION on")
        paths["train_long_seq"] = drive_train(
            torch, np, dev, params, train_config(), 2, PER_STEP_LONG,
            what="_LONG_SEQ_FUSION on")
        paths["train_long_seq_t_dropout_0"] = drive_train(
            torch, np, dev, params, train_config(0.0), 1,
            PER_STEP_LONG_NO_DROPOUT, what="_LONG_SEQ_FUSION on")
    with policies(save_qkv=True):
        paths["train_save_qkv"] = drive_train(
            torch, np, dev, params, train_config(), 2, PER_STEP_SAVE_QKV,
            what="_SAVE_QKV on")
    paths["train_accum_2"] = drive_train(
        torch, np, dev, params, train_config(), 2, PER_STEP_ACCUM_2,
        what="accum_steps 2 (2 x 4 images)", accum_steps=2, compare=False)
    paths["train_adam_clip"] = drive_train(
        torch, np, dev, params, train_config(), 2, PER_STEP,
        what="Adam, clip_norm 1.0", optimizer="adam", clip_norm=1.0, lr=1e-4,
        compare=False)
    time_coattention(torch, np, dev, cfg, state)
    paths.update(drive_data_path(torch, np, dev, cfg, params, state))

    meta = {"nms_keep_mask": ("ait_tpu_torch/csrc/nms.cu",
                              "ait_tpu/ops/nms_pallas.py:133"),
            "sh_attention_fwd": ("ait_tpu_torch/csrc/sh_attention.cu",
                                 "ait_tpu/ops/pallas_attention.py:746"),
            "ffn_fwd": ("ait_tpu_torch/csrc/ffn.cu",
                        "ait_tpu/ops/pallas_ffn.py:195"),
            "posln_fwd": ("ait_tpu_torch/csrc/posln.cu",
                          "ait_tpu/ops/pallas_ffn.py:355"),
            "sh_attention_saved": ("ait_tpu_torch/csrc/sh_attention.cu",
                                   "ait_tpu/ops/pallas_attention.py:760"),
            # the per-pair kernel, then the products on csrc/gemm.cu
            "sh_attention_bwd": ("ait_tpu_torch/csrc/sh_attention.cu",
                                 "ait_tpu/ops/pallas_attention.py:630"),
            # the products on csrc/gemm.cu, the LayerNorm backward on
            # csrc/posln.cu
            "ffn_bwd": ("ait_tpu_torch/csrc/gemm.cu",
                        "ait_tpu/ops/pallas_ffn.py:216"),
            "posln_bwd": ("ait_tpu_torch/csrc/posln.cu",
                          "ait_tpu/ops/pallas_ffn.py:387"),
            # the LayerNorm part of the FFN backward's kernel (:135-151)
            "ln_bwd_ffn": ("ait_tpu_torch/csrc/posln.cu",
                           "ait_tpu/ops/pallas_ffn.py:104"),
            # the dropout forms: the same kernels, the masks from a seed
            "sh_attention_drop_fwd": ("ait_tpu_torch/csrc/sh_attention.cu",
                                      "ait_tpu/ops/pallas_attention.py:915"),
            "sh_attention_drop_bwd": ("ait_tpu_torch/csrc/sh_attention.cu",
                                      "ait_tpu/ops/pallas_attention.py:937"),
            "ffn_drop_fwd": ("ait_tpu_torch/csrc/ffn.cu",
                             "ait_tpu/ops/pallas_ffn.py:195"),
            "ffn_drop_bwd": ("ait_tpu_torch/csrc/gemm.cu",
                             "ait_tpu/ops/pallas_ffn.py:216"),
            "posln_drop_fwd": ("ait_tpu_torch/csrc/posln.cu",
                               "ait_tpu/ops/pallas_ffn.py:355"),
            "posln_drop_bwd": ("ait_tpu_torch/csrc/posln.cu",
                               "ait_tpu/ops/pallas_ffn.py:387"),
            "keep_mask_dump": ("ait_tpu_torch/csrc/dropout.cu",
                               "ait_tpu/ops/pallas_attention.py:954"),
            # the tiled kernels of the long-sequence and 65-128 token
            # regimes (their projections and weight gradients on
            # csrc/gemm.cu)
            **{f"sh_attention_general_{k}": (
                "ait_tpu_torch/csrc/sh_attention_general.cu",
                f"ait_tpu/ops/pallas_attention.py:{line}")
               for k, line in (("fwd", 400), ("saved", 400), ("bwd", 724),
                               ("drop_fwd", 400), ("drop_bwd", 724))},
            # the save-qkv policy: the short kernels with q/k/v saved and read
            "sh_attention_saveqkv_fwd": ("ait_tpu_torch/csrc/sh_attention.cu",
                                         "ait_tpu/ops/pallas_attention.py:394"),
            "sh_attention_saveqkv_bwd": ("ait_tpu_torch/csrc/sh_attention.cu",
                                         "ait_tpu/ops/pallas_attention.py:693"),
            # the products inside the FFN backward's body (and the attention
            # backward's, ait_tpu/ops/pallas_attention.py:412 `_bwd_kernel`)
            "gemm": ("ait_tpu_torch/csrc/gemm.cu",
                     "ait_tpu/ops/pallas_ffn.py:104")}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(v[name] for v in paths.values()),
         "launches_by_path": {k: v[name] for k, v in paths.items()},
         "library_ms": None, **results[name]}
        for name, (src, rep) in meta.items()]}
    line["kernels"][-1].update(
        fma_launches=sum(v["gemm_fma"] for v in paths.values()),
        fma_launches_by_path={k: v["gemm_fma"] for k, v in paths.items()})
    log(smi)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
