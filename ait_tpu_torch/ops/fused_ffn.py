"""Fused position-wise FFN and positional-encoding + LayerNorm glue, forward
and backward (counterpart of ait_tpu/ops/pallas_ffn.py).

* `fused_ffn`: relu(x @ w1 + b1) @ w2 + b2 -> + x -> LayerNorm, over flat
  rows [N, D]; the wrapper of csrc/ffn.cu, which replaces
  ait_tpu/ops/pallas_ffn.py:195 fused_ffn.
* `fused_ffn_bwd`: its backward, recomputed from x; replaces
  ait_tpu/ops/pallas_ffn.py:216 _ffn_bwd.  On the card: the recompute and
  the input and weight gradients on csrc/gemm.cu, the LayerNorm backward on
  csrc/posln.cu's `ln_bwd`.
* `fused_posln`: LayerNorm(x + pos[i mod T]) over flat pair-major rows; the
  wrapper of csrc/posln.cu, which replaces ait_tpu/ops/pallas_ffn.py:355
  fused_posln.  `fused_posln_bwd` is its backward (csrc/posln.cu `ln_bwd`,
  replacing ait_tpu/ops/pallas_ffn.py:387 _posln_vjp_bwd); the fixed
  position table gets a zero gradient.
* `FusedFFN` and `FusedPosLN` are the autograd Functions over them; `ffn`
  and `posln` are what the model calls.

Dropout (training): the FFN drops its output y2 = y1 @ w2 + b2 before the
residual, the glue drops x + pos before the LayerNorm, each kept value
scaled by 1 / keep_prob.  With keep_prob < 1 and a `seed` ([2] int32, on the
operands' device) the kernels draw the keep-mask from the port's Philox
stream (csrc/philox.cuh; tag 3 for the FFN, 4 for the glue, a block per
absolute row), forward and backward alike, as the Pallas kernels draw theirs
in-kernel (pallas_ffn.py:70 `_gen_keep`, :288-294).  The plain versions draw
the same mask from `ops/philox.py`, or take it as `keep` ([N, D] 0/1, as the
JAX package's references do; the CPU parity tests inject masks so), and
multiply by keep * (1 / keep_prob) in f32, as those do.  A wrapper counts a
launch at keep_prob 1 in `launches`, with dropout in `dropout_launches`.

LayerNorm eps is 1e-6 with f32 statistics.  A CUDA tensor goes to the
kernel, a CPU tensor to the plain version beside it (`ffn_reference`,
`posln_reference`, and for the backward, torch autograd through them:
`ffn_bwd_reference`, `posln_bwd_reference`).

csrc/posln.cu's two kernels run in persistent blocks of 8 warps whose grid
the wrappers compute here (`posln_grid`, `ln_bwd_grid`: as many blocks as
the card's SMs hold at once, given each kernel's ring of row slots in
shared memory; warp w of block b walks rows b * 8 + w, then every
8 * blocks-th row after it, `grid_rows`).  `ln_bwd` sums dln_s and dln_b
in a fixed order over that grid (`ln_param_sums` emulates it), so two
calls give the same bits.  `ln_bwd_reference` is the plain version of the
C entry `ln_bwd` itself, the LayerNorm backward that the glue and the FFN
backward share.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ait_tpu_torch.device import device_sms
from ait_tpu_torch.ops import _build, _gemm, philox
from ait_tpu_torch.ops.dropout_masks import count_launch, seed_args
from ait_tpu_torch.ops.fused_attention import layer_norm_f32, vjp_of

# the widths the kernels are compiled for (the flagship AIT head)
KERNEL_D, KERNEL_HIDDEN = 512, 2048


def _plain_keep(keep, keep_prob, seed, tag, x):
    """The [N, D] keep-mask a plain version applies: the given one, else the
    Philox stream's for `seed` at keep_prob < 1, else None."""
    if keep is not None or keep_prob >= 1.0:
        return keep
    n, d = x.shape
    return philox.keep_mask(seed, tag, 1, n, d, keep_prob).view(n, d)


def ffn_reference(x, w1, b1, w2, b2, ln_s, ln_b, keep=None, keep_prob=1.0,
                  seed=None, relu_mask=None):
    """x [N, D] in the compute dtype; w1 [D, H], w2 [H, D] in the JAX layout;
    biases and LayerNorm params f32; the output dropout's mask `keep` [N, D]
    or `seed` at keep_prob < 1.  relu_mask [N, H] bool: where the relu
    passes (default: pre-activation > 0); a caller holding another
    evaluation against this one passes that evaluation's mask, so that a
    pre-activation whose sign the f32 summation order decides falls alike."""
    dt = x.dtype
    keep = _plain_keep(keep, keep_prob, seed, philox.TAG_FFN, x)
    # jnp.dot(..., preferred_element_type=f32): exact products, f32 sums;
    # relu's derivative is 0 at a pre-activation of exactly 0, as the Pallas
    # backward's `y1 > 0` mask has it (pallas_ffn.py:128)
    y1 = x.float() @ w1.to(dt).float() + b1
    y1 = (torch.relu(y1) if relu_mask is None
          else torch.where(relu_mask, y1, 0.0)).to(dt)
    y2 = y1.float() @ w2.to(dt).float() + b2
    if keep is not None:
        y2 = y2 * keep.float() * (1.0 / keep_prob)
    y = y2 + x.float()
    return layer_norm_f32(y, ln_s, ln_b).to(dt)


def posln_reference(x, pos, ln_s, ln_b, keep=None, keep_prob=1.0, seed=None):
    """x [N, D] flat pair-major rows, pos [T, D] with N % T == 0 (row i gets
    position i % T); the dropout's mask `keep` [N, D] or `seed` at
    keep_prob < 1."""
    t = pos.shape[0]
    n = x.shape[0]
    keep = _plain_keep(keep, keep_prob, seed, philox.TAG_GLUE, x)
    y = x.float() + pos.float().repeat(n // t, 1)
    if keep is not None:
        y = y * keep.float() * (1.0 / keep_prob)
    return layer_norm_f32(y, ln_s, ln_b).to(x.dtype)


def _check_rows(name, x, params):
    req = _build.require
    req(x.is_cuda, f"{name}: the kernel runs on CUDA tensors")
    req(x.dtype in (torch.float32, torch.bfloat16),
        f"{name}: the kernel takes float32 or bfloat16")
    req(x.dim() == 2 and x.shape[1] == KERNEL_D,
        f"{name}: x must be [N, {KERNEL_D}]")
    _build.require_operands(name, x.device, (x,) + tuple(params))


_I, _P = ctypes.c_int, ctypes.c_void_p
_DROP = [_P, ctypes.c_uint, ctypes.c_float]        # seed, threshold, 1 / keep
_FFN_FUNCS = {"ffn_fwd": [_I] + [_P] * 8 + [_I] + _DROP + [_P]}
_POSLN_FUNCS = {"posln_fwd": [_I] + [_P] * 5 + [_I] * 3 + _DROP + [_P],
                "ln_bwd": [_I] * 3 + [_P] * 2 + [_I] + [_P] * 6 +
                [_I] * 3 + _DROP + [_P, _P]}
# ln_bwd's dropout modes (csrc/posln.cu)
_LN_PLAIN, _LN_GLUE, _LN_FFN = 0, 1, 2

# csrc/posln.cu's launch shape: blocks of LN_WARPS warps, each warp with a
# ring of LN_STAGES row slots in shared memory (a slot holds one row of
# each array the kernel reads); as many blocks a SM as the rings leave room
# for, at most the kernels' __launch_bounds__ minimum (3 for the forward,
# 2 for the backward, which holds more registers)
LN_WARPS, LN_STAGES = 8, 3
SM_SHARED_BYTES = 228 * 1024       # a Hopper SM's; a block reserves 1 KB
# the second pass of ln_bwd: warps a block, each summing every 32nd partial
LN_REDUCE_WARPS = 32


def _rows_grid(n, sms, slot_bytes, most_per_sm):
    ring = LN_WARPS * LN_STAGES * slot_bytes
    per_sm = max(1, min(most_per_sm, SM_SHARED_BYTES // (ring + 1024)))
    return max(1, min(-(-n // LN_WARPS), sms * per_sm))


def posln_grid(n, sms, itemsize):
    """Blocks of csrc/posln.cu's forward for n rows on a card of `sms` SMs,
    x and pos of `itemsize` bytes an element."""
    return _rows_grid(n, sms, 2 * KERNEL_D * itemsize, 3)


def ln_bwd_grid(n, sms, x_itemsize, add_itemsize):
    """Blocks of csrc/posln.cu's `ln_bwd` (and rows of its partials) for n
    rows: x and g of `x_itemsize` bytes an element, the addend of
    `add_itemsize`."""
    return _rows_grid(n, sms, KERNEL_D * (2 * x_itemsize + add_itemsize), 2)


def grid_rows(blocks, n):
    """{(block, warp): the rows that warp walks, in order} for a grid of
    `blocks` persistent blocks over n rows."""
    stride = blocks * LN_WARPS
    return {(b, w): range(b * LN_WARPS + w, n, stride)
            for b in range(blocks) for w in range(LN_WARPS)}


def ln_param_sums(g, xhat, blocks):
    """(dln_s, dln_b) = (sum_i g * xhat, sum_i g) over f32 rows [N, D] in
    `ln_bwd`'s fixed order for a grid of `blocks`: each warp sums its rows
    (`grid_rows`) in order, dln_s as an FMA a row (here a float64 product
    and sum rounded to f32); each block adds its 8 warps in order; then
    warp v of the second pass adds partials v, v + 32, ... in order, and the
    32 warp sums are added in order."""
    n, d = g.shape
    stride = blocks * LN_WARPS
    rounds = -(-n // stride)
    pad = (0, 0, 0, rounds * stride - n)        # rows of zeros add nothing
    gp = F.pad(g, pad).view(rounds, stride, d)
    xp = F.pad(xhat, pad).view(rounds, stride, d)
    zeros = functools.partial(torch.zeros, dtype=torch.float32,
                              device=g.device)
    ps, pb = zeros(stride, d), zeros(stride, d)
    for k in range(rounds):
        ps = (ps.double() + gp[k].double() * xp[k].double()).float()
        pb = pb + gp[k]
    out = []
    for warp_sums in (ps, pb):
        per_block = warp_sums.view(blocks, LN_WARPS, d)
        part = zeros(blocks, d)
        for w in range(LN_WARPS):
            part = part + per_block[:, w]
        passes = -(-blocks // LN_REDUCE_WARPS)
        part = F.pad(part, (0, 0, 0, passes * LN_REDUCE_WARPS - blocks))
        acc = zeros(LN_REDUCE_WARPS, d)
        for k in range(passes):
            acc = acc + part.view(passes, LN_REDUCE_WARPS, d)[k]
        total = zeros(d)
        for v in range(LN_REDUCE_WARPS):
            total = total + acc[v]
        out.append(total)
    return tuple(out)


def ln_bwd_reference(x, add, period, ln_s, g, mode=_LN_PLAIN, keep=None,
                     keep_prob=1.0, out_dtype=torch.float32, blocks=None):
    """Plain version of csrc/posln.cu `ln_bwd`: (dx, dln_s, dln_b, dy2) of
    the LayerNorm of y = x + add[i mod period] for the output cotangent g,
    in f32 with the JAX kernels' formula (pallas_ffn.py:135-151, :319-341).
    Dropout by `mode` with the [N, D] 0/1 mask `keep`, m = keep / keep_prob:
    the glue's y = (x + add) * m and dx = dy * m; the FFN's y = x + add * m,
    dx = dy and dy2 = dy * m (else None).  dx in out_dtype.  With `blocks`,
    dln_s and dln_b are summed in the kernel's fixed order for that grid
    (`ln_param_sums`), else by torch."""
    n = x.shape[0]
    a = add.float()[torch.arange(n, device=x.device) % period]
    m = None
    if mode != _LN_PLAIN:
        _build.require(keep is not None, "ln_bwd_reference: a dropout mode "
                       "needs its keep mask")
        m = keep.float() * (1.0 / keep_prob)
    if mode == _LN_GLUE:
        y = (x.float() + a) * m
    elif mode == _LN_FFN:
        y = x.float() + a * m
    else:
        y = x.float() + a
    mu = y.mean(dim=-1, keepdim=True)
    var = ((y - mu) ** 2).mean(dim=-1, keepdim=True)
    r = torch.rsqrt(var + 1e-6)
    xhat = (y - mu) * r
    gf = g.float()
    dxhat = gf * ln_s
    dy = r * (dxhat - dxhat.mean(dim=-1, keepdim=True) -
              xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
    if blocks is None:
        dln_s, dln_b = (gf * xhat).sum(dim=0), gf.sum(dim=0)
    else:
        dln_s, dln_b = ln_param_sums(gf, xhat, blocks)
    dy2 = dy * m if mode == _LN_FFN else None
    dx = dy * m if mode == _LN_GLUE else dy
    return dx.to(out_dtype), dln_s, dln_b, dy2


def _kernel_drop(name, x, keep, keep_prob, seed):
    """(seed pointer, threshold, 1 / keep_prob) for a kernel; no operand
    masks: the kernels draw theirs from the seed."""
    _build.require(keep is None, f"{name}: the kernel draws its dropout mask "
                   "from a seed; operand masks are for the plain version")
    return seed_args(name, keep_prob, seed, x.device)


def fused_ffn(x, w1, b1, w2, b2, ln_s, ln_b, keep=None, keep_prob=1.0,
              seed=None):
    """Same arguments and result as `ffn_reference`; on CUDA w1 and w2 must
    already be in x's dtype, and dropout comes from `seed`."""
    if x.device.type == "cpu":
        return ffn_reference(x, w1, b1, w2, b2, ln_s, ln_b, keep=keep,
                             keep_prob=keep_prob, seed=seed)
    _check_rows("ffn", x, (w1, b1, w2, b2, ln_s, ln_b))
    drop = _kernel_drop("ffn", x, keep, keep_prob, seed)
    req = _build.require
    d, h = KERNEL_D, KERNEL_HIDDEN
    req(tuple(w1.shape) == (d, h) and tuple(w2.shape) == (h, d) and
        w1.dtype == x.dtype and w2.dtype == x.dtype,
        f"ffn: w1 must be [{d}, {h}] and w2 [{h}, {d}] in x's dtype")
    for name, t, n in (("b1", b1, h), ("b2", b2, d), ("ln_s", ln_s, d),
                       ("ln_b", ln_b, d)):
        req(tuple(t.shape) == (n,) and t.dtype == torch.float32,
            f"ffn: {name} must be float32 [{n}]")
    out = torch.empty_like(x)
    if x.shape[0]:
        lib = _build.load("ffn", _FFN_FUNCS)
        _build.check(lib.ffn_fwd(
            int(x.dtype == torch.bfloat16), x.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), ln_s.data_ptr(),
            ln_b.data_ptr(), out.data_ptr(), x.shape[0], *drop,
            _build.stream_ptr(x.device)), "ffn_fwd")
        count_launch(fused_ffn, keep_prob)
    return out


fused_ffn.launches = fused_ffn.dropout_launches = 0


def fused_posln(x, pos, ln_s, ln_b, keep=None, keep_prob=1.0, seed=None):
    """Same arguments and result as `posln_reference`; on CUDA pos must be
    in x's dtype, and dropout comes from `seed`."""
    if x.device.type == "cpu":
        return posln_reference(x, pos, ln_s, ln_b, keep=keep,
                               keep_prob=keep_prob, seed=seed)
    _check_rows("posln", x, (pos, ln_s, ln_b))
    drop = _kernel_drop("posln", x, keep, keep_prob, seed)
    req = _build.require
    n, d = x.shape
    t = pos.shape[0]
    req(pos.dim() == 2 and pos.shape[1] == d and pos.dtype == x.dtype and
        t > 0 and n % t == 0,
        "posln: pos must be [T, D] in x's dtype with N % T == 0")
    for name, p in (("ln_s", ln_s), ("ln_b", ln_b)):
        req(tuple(p.shape) == (d,) and p.dtype == torch.float32,
            f"posln: {name} must be float32 [{d}]")
    out = torch.empty_like(x)
    if n:
        _posln_launch(x, pos, ln_s, ln_b, out, drop)
        count_launch(fused_posln, keep_prob)
    return out


fused_posln.launches = fused_posln.dropout_launches = 0


def _posln_launch(x, pos, ln_s, ln_b, out, drop):
    """csrc/posln.cu `posln_fwd` on checked operands (n >= 1 rows) over
    `posln_grid`'s persistent blocks."""
    n, t = x.shape[0], pos.shape[0]
    blocks = posln_grid(n, device_sms(x.device), x.element_size())
    lib = _build.load("posln", _POSLN_FUNCS)
    _build.check(lib.posln_fwd(
        int(x.dtype == torch.bfloat16), x.data_ptr(), pos.data_ptr(),
        ln_s.data_ptr(), ln_b.data_ptr(), out.data_ptr(), n, t, blocks,
        *drop, _build.stream_ptr(x.device)), "posln_fwd")


# ------------------------------------------------------------------ backward


def ffn_bwd_reference(x, w1, b1, w2, b2, ln_s, ln_b, g, keep=None,
                      keep_prob=1.0, seed=None, relu_mask=None):
    """Plain backward: torch autograd through `ffn_reference`.  Returns the
    cotangents of (x, w1, b1, w2, b2, ln_s, ln_b)."""
    keep = _plain_keep(keep, keep_prob, seed, philox.TAG_FFN, x)
    return vjp_of(lambda *a: ffn_reference(*a, keep, keep_prob,
                                           relu_mask=relu_mask),
                  (x, w1, b1, w2, b2, ln_s, ln_b), g)


def posln_bwd_reference(x, pos, ln_s, ln_b, g, keep=None, keep_prob=1.0,
                        seed=None):
    """Plain backward: torch autograd through `posln_reference`; the
    position table gets zeros, as in the JAX package."""
    keep = _plain_keep(keep, keep_prob, seed, philox.TAG_GLUE, x)
    dx, dln_s, dln_b = vjp_of(
        lambda x_, s_, b_: posln_reference(x_, pos, s_, b_, keep, keep_prob),
        (x, ln_s, ln_b), g)
    return dx, torch.zeros_like(pos), dln_s, dln_b


def _ln_bwd(x, add, period, ln_s, g, out_dtype, mode=_LN_PLAIN,
            drop=(None, 0, 1.0)):
    """csrc/posln.cu `ln_bwd`: (dx, dln_s, dln_b, dy2) of the LayerNorm of
    x + add[i mod period] on the card (n >= 1 rows), with the dropout of
    `mode` (drop = the kernel's seed pointer, threshold and 1 / keep_prob);
    one entry, two kernels: the rows over `ln_bwd_grid`'s persistent blocks,
    then the fixed-order sum of the blocks' [blocks, 2, 512] partials.  dy2
    [N, 512] f32 in the FFN mode, else None."""
    n = x.shape[0]
    blocks = ln_bwd_grid(n, device_sms(x.device), x.element_size(),
                         add.element_size())
    dev = x.device
    dx = torch.empty((n, KERNEL_D), dtype=out_dtype, device=dev)
    dy2 = (torch.empty((n, KERNEL_D), dtype=torch.float32, device=dev)
           if mode == _LN_FFN else None)
    part = torch.empty((blocks, 2, KERNEL_D), dtype=torch.float32, device=dev)
    dln_s = torch.empty(KERNEL_D, dtype=torch.float32, device=dev)
    dln_b = torch.empty(KERNEL_D, dtype=torch.float32, device=dev)
    lib = _build.load("posln", _POSLN_FUNCS)
    _build.check(lib.ln_bwd(
        int(x.dtype == torch.bfloat16), int(add.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16), x.data_ptr(), add.data_ptr(),
        period, ln_s.data_ptr(), g.data_ptr(), dx.data_ptr(),
        part.data_ptr(), dln_s.data_ptr(), dln_b.data_ptr(), n, blocks, mode,
        *drop, dy2.data_ptr() if dy2 is not None else None,
        _build.stream_ptr(dev)), "ln_bwd")
    return dx, dln_s, dln_b, dy2


def fused_ffn_bwd(x, w1, b1, w2, b2, ln_s, ln_b, g, keep=None, keep_prob=1.0,
                  seed=None):
    """Same arguments and result as `ffn_bwd_reference`; on CUDA the
    operands are those `fused_ffn` takes, and g is [N, D] in x's dtype.

    Kernel path, with the JAX kernel's cast points (pallas_ffn.py:126-164):
    y1 = relu(x @ w1 + b1) rounded to x's dtype, y2 = y1 @ w2 + b2 (f32),
    dy = LayerNorm backward of y2 * m + x (f32, m = keep / keep_prob, 1
    without dropout), dy2 = dy * m, dy1 = (dy2 as x's dtype) @ w2^T where
    y1 > 0 (f32), dx = (dy1 as x's dtype) @ w1^T + dy (the residual takes the
    unmasked dy); dw1 = x^T dy1, dw2 = y1^T dy2, db1, db2 column sums.  The
    LayerNorm backward (csrc/posln.cu `ln_bwd`) regenerates m from the seed
    and writes dy2 beside dy, one more [N, 512] f32 array with dropout
    (134 MB at N = 65,536).  It stores y1 [N, 2048] in x's dtype and y2, dy
    (dy2) [N, 512] and dy1 [N, 2048] in f32 between launches."""
    if x.device.type == "cpu":
        return ffn_bwd_reference(x, w1, b1, w2, b2, ln_s, ln_b, g, keep=keep,
                                 keep_prob=keep_prob, seed=seed)
    _check_rows("ffn_bwd", x, (w1, b1, w2, b2, ln_s, ln_b, g))
    drop = _kernel_drop("ffn_bwd", x, keep, keep_prob, seed)
    req = _build.require
    d, h = KERNEL_D, KERNEL_HIDDEN
    dt = x.dtype
    req(tuple(w1.shape) == (d, h) and tuple(w2.shape) == (h, d) and
        w1.dtype == dt and w2.dtype == dt,
        f"ffn_bwd: w1 must be [{d}, {h}] and w2 [{h}, {d}] in x's dtype")
    for name, t, n in (("b1", b1, h), ("b2", b2, d), ("ln_s", ln_s, d),
                       ("ln_b", ln_b, d)):
        req(tuple(t.shape) == (n,) and t.dtype == torch.float32,
            f"ffn_bwd: {name} must be float32 [{n}]")
    req(g.shape == x.shape and g.dtype == dt,
        "ffn_bwd: g must be [N, D] in x's dtype")
    if not x.shape[0]:
        return (torch.zeros_like(x), torch.zeros_like(w1),
                torch.zeros_like(b1), torch.zeros_like(w2),
                torch.zeros_like(b2), torch.zeros_like(ln_s),
                torch.zeros_like(ln_b))
    out = _ffn_bwd_launches(x, w1, b1, w2, b2, ln_s, g, keep_prob, drop)
    count_launch(fused_ffn_bwd, keep_prob)
    return out


# `ln_launches`: its LayerNorm backward's launches of csrc/posln.cu `ln_bwd`
fused_ffn_bwd.launches = fused_ffn_bwd.dropout_launches = 0
fused_ffn_bwd.ln_launches = 0


def _ffn_bwd_launches(x, w1, b1, w2, b2, ln_s, g, keep_prob, drop):
    """`fused_ffn_bwd`'s launches on checked operands (n >= 1 rows): the
    recompute's two products, `ln_bwd` on y2, the four gradient products
    and the two bias column sums."""
    dt = x.dtype
    gemm, NN, NT, TN = _gemm.gemm, _gemm.NN, _gemm.NT, _gemm.TN
    y1 = gemm(NN, x, w1, bias=b1, relu=True, out_dtype=dt)
    y2 = gemm(NN, y1, w2, bias=b2)
    dy, dln_s, dln_b, dy2 = _ln_bwd(
        x, y2, x.shape[0], ln_s, g, torch.float32,
        _LN_FFN if keep_prob < 1.0 else _LN_PLAIN, drop)
    fused_ffn_bwd.ln_launches += 1
    del y2
    if dy2 is None:
        dy2 = dy
    dy1 = gemm(NT, dy2.to(dt), w2, mask=y1)
    dx = gemm(NT, dy1.to(dt), w1, cadd=dy).to(dt)
    dw1 = gemm(TN, x, dy1, out_dtype=dt)
    dw2 = gemm(TN, y1, dy2, out_dtype=dt)
    db1, db2 = _gemm.colsum(dy1), _gemm.colsum(dy2)
    return dx, dw1, db1, dw2, db2, dln_s, dln_b


def fused_posln_bwd(x, pos, ln_s, ln_b, g, keep=None, keep_prob=1.0,
                    seed=None):
    """Same arguments and result as `posln_bwd_reference`; with dropout
    `ln_bwd` regenerates the forward's mask from the seed and scales dx by
    it."""
    if x.device.type == "cpu":
        return posln_bwd_reference(x, pos, ln_s, ln_b, g, keep=keep,
                                   keep_prob=keep_prob, seed=seed)
    _check_rows("posln_bwd", x, (pos, ln_s, ln_b, g))
    drop = _kernel_drop("posln_bwd", x, keep, keep_prob, seed)
    req = _build.require
    n, d = x.shape
    t = pos.shape[0]
    req(pos.dim() == 2 and pos.shape[1] == d and pos.dtype == x.dtype and
        t > 0 and n % t == 0,
        "posln_bwd: pos must be [T, D] in x's dtype with N % T == 0")
    for name, p in (("ln_s", ln_s), ("ln_b", ln_b)):
        req(tuple(p.shape) == (d,) and p.dtype == torch.float32,
            f"posln_bwd: {name} must be float32 [{d}]")
    req(g.shape == x.shape and g.dtype == x.dtype,
        "posln_bwd: g must be [N, D] in x's dtype")
    if not n:
        return (torch.zeros_like(x), torch.zeros_like(pos),
                torch.zeros_like(ln_s), torch.zeros_like(ln_b))
    out = _posln_bwd_launches(x, pos, ln_s, g, keep_prob, drop)
    count_launch(fused_posln_bwd, keep_prob)
    return out


fused_posln_bwd.launches = fused_posln_bwd.dropout_launches = 0


def _posln_bwd_launches(x, pos, ln_s, g, keep_prob, drop):
    """`fused_posln_bwd`'s launch on checked operands (n >= 1 rows): one
    `ln_bwd` with the position table as the addend, in the glue's dropout
    mode at keep_prob < 1; dx in x's dtype."""
    mode = _LN_GLUE if keep_prob < 1.0 else _LN_PLAIN
    dx, dln_s, dln_b, _ = _ln_bwd(x, pos, pos.shape[0], ln_s, g, x.dtype,
                                  mode, drop)
    return dx, torch.zeros_like(pos), dln_s, dln_b


class FusedFFN(torch.autograd.Function):
    """`fused_ffn` with `fused_ffn_bwd` as its backward; the dropout
    arguments (keep, keep_prob, seed) reach both."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, ln_s, ln_b, keep, keep_prob, seed):
        ctx.save_for_backward(x, w1, b1, w2, b2, ln_s, ln_b)
        ctx.drop = (keep, keep_prob, seed)
        return fused_ffn(x, w1, b1, w2, b2, ln_s, ln_b, keep, keep_prob, seed)

    @staticmethod
    def backward(ctx, g):
        return fused_ffn_bwd(*ctx.saved_tensors, g.contiguous(),
                             *ctx.drop) + (None,) * 3


class FusedPosLN(torch.autograd.Function):
    """`fused_posln` with `fused_posln_bwd` as its backward; the dropout
    arguments reach both."""

    @staticmethod
    def forward(ctx, x, pos, ln_s, ln_b, keep, keep_prob, seed):
        ctx.save_for_backward(x, pos, ln_s, ln_b)
        ctx.drop = (keep, keep_prob, seed)
        return fused_posln(x, pos, ln_s, ln_b, keep, keep_prob, seed)

    @staticmethod
    def backward(ctx, g):
        return fused_posln_bwd(*ctx.saved_tensors, g.contiguous(),
                               *ctx.drop) + (None,) * 3


def ffn(x, w1, b1, w2, b2, ln_s, ln_b, keep=None, keep_prob=1.0, seed=None):
    """The model's FFN block: `fused_ffn`, differentiable."""
    return FusedFFN.apply(x, w1, b1, w2, b2, ln_s, ln_b, keep, keep_prob,
                          seed)


def posln(x, pos, ln_s, ln_b, keep=None, keep_prob=1.0, seed=None):
    """The model's input glue: `fused_posln`, differentiable."""
    return FusedPosLN.apply(x, pos, ln_s, ln_b, keep, keep_prob, seed)
