"""Fused selective-head attention, forward and backward (counterpart of
ait_tpu/ops/pallas_attention.py).

One call computes the whole SHBlock multi-head attention of the AIT head
for P pair-sequences: q/k/v projections (8 heads, d_k = d_v = 64), the
scaled masked softmax (fill -1e9), P.V, the selective-head gate (sum over
heads -> mean over tokens -> Linear(d_v -> H*d_v) -> softmax over heads in
f32 -> weighted head sum), fc (d_v -> D), the residual and a LayerNorm with
eps 1e-6 and f32 statistics.  The mask [Tq, Tk] is shared by all pairs.

`sh_attention_reference` is the plain version, a line-by-line port of
`_reference_impl` with its casts.  `fused_sh_attention` is the wrapper of the
CUDA kernels (which replace ait_tpu/ops/pallas_attention.py:746
fused_sh_attention): a CUDA tensor goes to a kernel, a CPU tensor to the
plain version.

Both kernel regimes (`kernel_regime`) start from the projections over all
pairs, q = x_q wq, k = x_kv wk, v = x_kv wv, f32 [P*T, D] (`project`, three
products on csrc/gemm.cu's tensor cores in bf16), and give one result:
* "short", both sides <= 64 tokens: the core kernel of csrc/sh_attention.cu
  (`short_core`), persistent blocks that take one pair at a time with the
  rest of the block on chip (scores, softmax, P v, the gate, fc on wgmma,
  LayerNorm);
* "general", everything else the JAX package fuses (both sides <= 128 tokens,
  or, its long-sequence regime, one side <= 128 and Tq * Tk <= 192 K: the
  co-attention's 1900 x 64 and 64 x 1900): csrc/sh_attention_general.cu, 64-row
  tiles across blocks with the per-head outputs in device memory between its
  launches.  `general_plan` splits the long side of a (head, pair) across
  blocks where the grid would leave SMs idle (ops/attention_general.py
  emulates the kernels' fixed-order sums over the splits).
Every wrapper counts a launch of the general regime in `general_launches` /
`general_dropout_launches`, of the short one in `launches` /
`dropout_launches` (one per call; the products count in `_gemm.gemm`).

Training:
* `fused_sh_attention_saved` is the same kernel that also writes each
  head's f32 attention output [H, P*Tq, d_v], exactly what its gate
  consumed (replaces the `save_oh` forward, pallas_attention.py:760 `_fwd`);
* `fused_sh_attention_bwd` is the backward from those saved outputs
  (replaces pallas_attention.py:630 `_fused_bwd_call`): the per-pair part in
  csrc/sh_attention.cu from the projections (`project` again, or the saved
  ones; `short_bwd_pairs`, whose plain version is
  `sh_attention_bwd_pairs_reference`), then the projections' input and
  weight gradients on csrc/gemm.cu (`bwd_products`).  Its plain version,
  `sh_attention_bwd_reference`, is torch autograd through
  `sh_attention_reference`.  The per-pair kernel's per-head products run
  on the tensor cores in a three-term bf16 split of both f32 operands;
  `split6_matmul` emulates them, `split_check` runs them alone;
* dropout (keep_prob < 1): both take the mask source of the JAX package's
  two dropout forms.  With `seed` ([2] int32 on the operands' device) the
  kernels draw the masks from the port's Philox stream (csrc/philox.cuh:
  tag 1 per head and pair for the probabilities, tag 2 per pair for fc's
  output), forward and backward alike, as `fused_sh_attention_rngdrop`
  (pallas_attention.py:891) draws them in-kernel; with `attn_keep` [H, P*Tq,
  Tk] and `out_keep` [P*Tq, D] (f32 0/1) they read them, as
  `fused_sh_attention_dropout` (:817) does.  The plain versions take the
  same arguments (a seed's masks from ops/philox.py) with
  `_reference_impl`'s cast points: the probabilities multiplied in f32, fc's
  output in its own dtype by 1 / keep_prob rounded to that dtype.  A wrapper
  counts a launch at keep_prob 1 in `launches`, with dropout in
  `dropout_launches`;
* the save-qkv policy (`_SAVE_QKV`, off by default as in the JAX package,
  pallas_attention.py:132-150): where both sides are <= 128 tokens the saved
  forward also writes the per-head q / sqrt(d_k), k and v [H, P*T, d_k] in
  f32 and the backward reads them instead of recomputing the projections
  (`save_qkv=True`, `qkv=`); such launches also count in `qkv_launches`;
* `FusedSHAttention` is the autograd Function over the two, and
  `sh_attention` what the model calls: the Function when an input needs a
  gradient or dropout is on, else the eval kernel, which writes no per-head
  outputs.
  `fused_sh_attention_rngdrop` and `fused_sh_attention_dropout` are the
  differentiable dropout forms, named as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ait_tpu_torch.device import device_sms
from ait_tpu_torch.ops import _build, _gemm, philox
from ait_tpu_torch.ops.dropout_masks import (count_launch, kernel_keep,
                                             seed_args)

LN_EPS = 1e-6

# the kernels' compiled widths (the flagship AIT head) and the longest
# sequence whose 8 per-head outputs fit in one block's shared memory (the
# short regime's kernels)
KERNEL_D, KERNEL_HEADS, KERNEL_DK, KERNEL_MAX_TOKENS = 512, 8, 64, 64
# what the JAX package fuses (models/attention.py:108-116,197-201): both
# sides up to FUSE_MAX_TOKENS, or (long-sequence regime) one side up to it
# and an attention area up to FUSE_MAX_AREA
FUSE_MAX_TOKENS, FUSE_MAX_AREA = 128, 192 * 1024

# Save the per-head q/k/v in the train forward and read them in the backward
# instead of recomputing the projections (pallas_attention.py:141 `_SAVE_QKV`);
# off by default, as there.  Read at call time by `FusedSHAttention`.
_SAVE_QKV = False


def fuse_short(tq: int, tk: int) -> bool:
    return 1 <= tq <= FUSE_MAX_TOKENS and 1 <= tk <= FUSE_MAX_TOKENS


def fuse_long(tq: int, tk: int) -> bool:
    return (tq >= 1 and tk >= 1 and min(tq, tk) <= FUSE_MAX_TOKENS and
            tq * tk <= FUSE_MAX_AREA)


def kernel_regime(tq: int, tk: int):
    """'short' (one block per pair), 'general' (tiled), or None where no
    kernel takes the shape."""
    if 1 <= tq <= KERNEL_MAX_TOKENS and 1 <= tk <= KERNEL_MAX_TOKENS:
        return "short"
    if fuse_short(tq, tk) or fuse_long(tq, tk):
        return "general"
    return None


# csrc/sh_attention_general.cu's tiles: 64 query rows or keys in its core
# kernels, 16 rows in its fc / LayerNorm kernels (out_fwd, out_bwd)
GENERAL_TILE, GENERAL_ROWS = 64, 16


class GeneralPlan(NamedTuple):
    """How csrc/sh_attention_general.cu splits one call: core_fwd and
    core_bwd_q take the key tiles in `ksplits` splits of `kchunk` tiles,
    core_bwd_kv the query tiles in `qsplits` splits of `qchunk`; out_fwd and
    out_bwd run `out_blocks` persistent blocks over the 16-row items."""
    ksplits: int
    kchunk: int
    qsplits: int
    qchunk: int
    out_blocks: int


def _split(tiles: int, blocks: int, sms: int):
    """(splits, tiles a split) of `tiles` for a grid of `blocks` blocks
    without splits, 2 resident an SM: the split whose waves of blocks times
    tiles a block is least (the fewest splits among equals), no split
    empty."""
    best = None
    for want in range(1, tiles + 1):
        chunk = -(-tiles // want)
        splits = -(-tiles // chunk)
        cost = -(-blocks * splits // (2 * sms)) * chunk
        if best is None or cost < best[0]:
            best = (cost, splits, chunk)
    return best[1], best[2]


@functools.lru_cache(maxsize=None)
def general_plan(p: int, tq: int, tk: int, sms: int) -> GeneralPlan:
    """The split plan of a general-regime call of P pairs on a card of `sms`
    SMs.  The co-attention's 64 x 1900 (i2q) has one query tile per (head,
    pair): its keys are split; its 1900 x 64 (q2i) has one key tile: the
    query tiles of core_bwd_kv are split."""
    qtiles = -(-tq // GENERAL_TILE)
    ktiles = -(-tk // GENERAL_TILE)
    ks, kc = _split(ktiles, qtiles * KERNEL_HEADS * p, sms)
    qs, qc = _split(qtiles, ktiles * KERNEL_HEADS * p, sms)
    items = p * -(-tq // GENERAL_ROWS)
    return GeneralPlan(ks, kc, qs, qc, max(1, min(items, 2 * sms)))


def _save_qkv_ok(tq: int, tk: int) -> bool:
    """Whether a train forward saves q/k/v: the policy is on and both sides
    are short (never in the long regime; pallas_attention.py:144-150)."""
    return _SAVE_QKV and fuse_short(tq, tk)


def layer_norm_f32(y: torch.Tensor, scale, bias) -> torch.Tensor:
    """LayerNorm of f32 rows with eps 1e-6, as the JAX package writes it."""
    mu = y.mean(dim=-1, keepdim=True)
    var = ((y - mu) ** 2).mean(dim=-1, keepdim=True)
    return (y - mu) * torch.rsqrt(var + LN_EPS) * scale + bias


def vjp_of(fn, inputs, g):
    """Cotangents of fn(*inputs) for the output cotangent g, by torch
    autograd (the plain backward of a fused kernel)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in inputs]
        out = fn(*leaves)
        return torch.autograd.grad(out, leaves, g)


def _plain_masks(attn_keep, out_keep, keep_prob, seed, p, tq, tk, d,
                 n_head):
    """The masks a plain version applies: the given ones, else the Philox
    stream's for `seed` at keep_prob < 1, else (None, None)."""
    if attn_keep is not None or keep_prob >= 1.0:
        return attn_keep, out_keep
    ak = philox.keep_mask(seed, philox.TAG_ATTN, n_head, p, tq * tk,
                          keep_prob)
    ok = philox.keep_mask(seed, philox.TAG_OUT, 1, p, tq * d, keep_prob)
    return ak.view(n_head, p * tq, tk), ok.view(p * tq, d)


def sh_attention_reference(x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w, ln_s,
                           ln_b, mask, n_head=8, d_k=64, d_v=64, *,
                           attn_keep=None, out_keep=None, keep_prob=1.0,
                           seed=None, return_oh=False, return_qkv=False):
    """x_q [P, Tq, D], x_kv [P, Tk, D], weights in the JAX layout ([in, out],
    x @ w), ln_s/ln_b f32, mask [Tq, Tk] bool (True = attend).  Dropout at
    keep_prob < 1: the masks attn_keep [H, P*Tq, Tk] and out_keep [P*Tq, D],
    or those of `seed`.  With return_oh, also the per-head attention outputs
    [H, P*Tq, d_v] in f32 (after the probability dropout); with return_qkv,
    then also the per-head (q / sqrt(d_k), k, v), each [H, P*T, d] in f32."""
    p, tq, d = x_q.shape
    tk = x_kv.shape[1]
    attn_keep, out_keep = _plain_masks(attn_keep, out_keep, keep_prob, seed,
                                       p, tq, tk, d, n_head)
    q = (x_q.reshape(p * tq, d) @ wq).reshape(p, tq, n_head, d_k)
    k = (x_kv.reshape(p * tk, d) @ wk).reshape(p, tk, n_head, d_k)
    v = (x_kv.reshape(p * tk, d) @ wv).reshape(p, tk, n_head, d_v)
    q = q.transpose(1, 2)
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)
    # einsum with preferred_element_type=f32: exact products, f32 sums
    attn = torch.einsum("phtd,phsd->phts", (q / (d_k ** 0.5)).float(),
                        k.float())
    attn = torch.where(mask[None, None], attn, -1e9)
    attn = torch.softmax(attn, dim=-1)
    if attn_keep is not None:
        ak = attn_keep.reshape(n_head, p, tq, tk).transpose(0, 1)
        attn = attn * ak.to(attn.dtype) * (1.0 / keep_prob)
    o32 = torch.einsum("phts,phsd->phtd", attn.to(v.dtype).float(),
                       v.float())
    o = o32.to(v.dtype)
    u = o.sum(dim=1)
    s = u.mean(dim=1)
    gate = (s @ sk_w + sk_b).reshape(p, n_head, d_v)
    gate = torch.softmax(gate.float(), dim=1).to(o.dtype)
    o = (o * gate[:, :, None, :]).sum(dim=1)
    y = (o.reshape(p * tq, d_v) @ fc_w).reshape(p, tq, d)
    if out_keep is not None:
        # jnp.asarray(1 / keep_prob, y.dtype): the factor rounded to y's type
        y = y * out_keep.reshape(p, tq, d).to(y.dtype) * torch.tensor(
            1.0 / keep_prob, dtype=y.dtype, device=y.device)
    y = y + x_q
    out = layer_norm_f32(y.float(), ln_s, ln_b).to(x_q.dtype)
    if not return_oh:
        return out
    res = (out, o32.transpose(0, 1).reshape(n_head, p * tq, d_v))
    if return_qkv:
        def heads(x, t, dh):
            return x.float().transpose(0, 1).reshape(n_head, p * t, dh)

        res += ((heads(q / (d_k ** 0.5), tq, d_k), heads(k, tk, d_k),
                 heads(v, tk, d_v)),)
    return res


def sh_attention_saved_reference(x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w,
                                 ln_s, ln_b, mask, n_head=8, d_k=64, d_v=64,
                                 save_qkv=False, **drop):
    """Plain version of `fused_sh_attention_saved`: (out, per-head outputs
    [H, P*Tq, d_v] f32) and, with save_qkv, the per-head (q scaled, k, v)."""
    return sh_attention_reference(x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w,
                                  ln_s, ln_b, mask, n_head, d_k, d_v,
                                  return_oh=True, return_qkv=save_qkv, **drop)


_I, _P = ctypes.c_int, ctypes.c_void_p
_DROP = [_P, _P, _P, ctypes.c_uint, ctypes.c_float]  # seed, masks, thresh, 1/kp
_FUNCS = {"sh_attention_fwd": [_I] + [_P] * 15 + [_I] * 3 + _DROP + [_P],
          "sh_attention_bwd_pairs": [_I] + [_P] * 11 + [_I] + [_P] * 9 +
          [_I] * 3 + _DROP + [_P, _P],
          "sh_attention_split_check": [_P, _P, _P, _I, _I, _I, _P]}
_GENERAL_FUNCS = {
    "sh_attention_general_fwd": [_I] + [_P] * 20 + [_I] * 6 + _DROP + [_P],
    "sh_attention_general_bwd": [_I, _I] + [_P] * 30 + [_I] * 8 + _DROP +
                                [_P]}


def _check(name, x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w, ln_s, ln_b, mask,
           n_head, d_k, d_v):
    """The shapes, types and layout the kernels take; raises otherwise."""
    req = _build.require
    req(x_q.is_cuda, f"{name}: the kernel runs on CUDA tensors")
    p, tq, d = x_q.shape
    tk = x_kv.shape[1]
    dt = x_q.dtype
    req(dt in (torch.float32, torch.bfloat16),
        f"{name}: the kernel takes float32 or bfloat16")
    req((d, n_head, d_k, d_v) ==
        (KERNEL_D, KERNEL_HEADS, KERNEL_DK, KERNEL_DK),
        f"{name}: the kernel is built for D=512, 8 heads, d_k=d_v=64")
    regime = kernel_regime(tq, tk)
    req(regime is not None,
        f"{name}: the kernels take sequences of 1..{FUSE_MAX_TOKENS} tokens "
        f"on both sides, or one side up to {FUSE_MAX_TOKENS} and Tq * Tk <= "
        f"{FUSE_MAX_AREA}; got {tq} x {tk}")
    req(x_kv.shape == (p, tk, d) and x_kv.dtype == dt,
        f"{name}: x_kv must be [P, Tk, D] in x_q's dtype")
    shapes = {"wq": (wq, (d, d)), "wk": (wk, (d, d)), "wv": (wv, (d, d)),
              "sk_w": (sk_w, (d_v, n_head * d_v)),
              "sk_b": (sk_b, (n_head * d_v,)), "fc_w": (fc_w, (d_v, d))}
    for wname, (t, shape) in shapes.items():
        req(tuple(t.shape) == shape and t.dtype == dt,
            f"{name}: {wname} must be {dt} {shape}")
    for lname, t in (("ln_s", ln_s), ("ln_b", ln_b)):
        req(tuple(t.shape) == (d,) and t.dtype == torch.float32,
            f"{name}: {lname} must be float32 [{d}]")
    req(mask.dtype == torch.bool and tuple(mask.shape) == (tq, tk),
        f"{name}: mask must be bool [Tq, Tk]")
    args = (x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w, ln_s, ln_b, mask)
    _build.require_operands(name, x_q.device, args)
    return p, tq, tk, d, dt, args, regime


def _kernel_drop(name, x_q, p, tq, tk, keep_prob, seed, attn_keep, out_keep):
    """The kernels' dropout arguments (seed, akeep, okeep pointers, threshold,
    1 / keep_prob): one mask source at keep_prob < 1, none at 1."""
    if keep_prob >= 1.0:
        return None, None, None, 0, 1.0
    if seed is not None:
        _build.require(attn_keep is None and out_keep is None,
                       f"{name}: a seed or operand masks, not both")
        ptr, thresh, inv = seed_args(name, keep_prob, seed, x_q.device)
        return ptr, None, None, thresh, inv
    thresh, inv = kernel_keep(name, keep_prob)
    _build.require(attn_keep is not None and out_keep is not None,
                   f"{name}: dropout needs a seed or both operand masks")
    for mname, t, shape in (("attn_keep", attn_keep, (KERNEL_HEADS, p * tq, tk)),
                            ("out_keep", out_keep, (p * tq, KERNEL_D))):
        _build.require(tuple(t.shape) == shape and t.dtype == torch.float32,
                       f"{name}: {mname} must be float32 {shape}")
    _build.require_operands(name, x_q.device, (attn_keep, out_keep))
    return None, attn_keep.data_ptr(), out_keep.data_ptr(), thresh, inv


_NO_DROP = (None, None, None, 0, 1.0)


def _f32(dev, *shape):
    return torch.empty(shape, dtype=torch.float32, device=dev)


def _count(fn, keep_prob, regime, qkv=False):
    """One launch of `fn`'s kernel, by regime and dropout; a launch that
    writes or reads saved q/k/v also counts in `qkv_launches`."""
    count_launch(fn, keep_prob, "general_" if regime == "general" else "")
    if qkv:
        fn.qkv_launches += 1


def _zero(fn, *counts):
    for name in counts:
        setattr(fn, name, 0)


_TRAIN_COUNTS = ("launches", "dropout_launches", "general_launches",
                 "general_dropout_launches", "qkv_launches")


def project(x_q, x_kv, wq, wk, wv):
    """The projections over all pairs on csrc/gemm.cu (its plain version for
    CPU tensors): q = x_q wq [P*Tq, D], k = x_kv wk and v = x_kv wv [P*Tk, D],
    f32 (head h in columns h*d_k.., q unscaled)."""
    d = x_q.shape[-1]
    xq2, xkv2 = x_q.reshape(-1, d), x_kv.reshape(-1, d)
    nn = _gemm.NN
    return (_gemm.gemm(nn, xq2, wq), _gemm.gemm(nn, xkv2, wk),
            _gemm.gemm(nn, xkv2, wv))


def sh_attention_core_reference(q, k, v, sk_w, sk_b, fc_w, x_q, ln_s, ln_b,
                                mask, n_head=8, d_k=64, d_v=64, *,
                                attn_keep=None, out_keep=None, keep_prob=1.0,
                                seed=None, return_oh=False, return_qkv=False):
    """Plain version of `short_core`: the block after the projections
    (`project`'s f32 q, k, v), with the Pallas kernel's cast points: f32
    between the products (the scores of q / sqrt(d_k), the probabilities,
    P v, the gate), the gated head sum rounded to x_q's dtype before fc, the
    LayerNorm in f32.  Same results as `sh_attention_reference`."""
    p, tq, d = x_q.shape
    tk = k.shape[0] // p
    dt = x_q.dtype
    attn_keep, out_keep = _plain_masks(attn_keep, out_keep, keep_prob, seed,
                                       p, tq, tk, d, n_head)
    qh = (q.float() / (d_k ** 0.5)).reshape(p, tq, n_head, d_k).transpose(1, 2)
    kh = k.float().reshape(p, tk, n_head, d_k).transpose(1, 2)
    vh = v.float().reshape(p, tk, n_head, d_v).transpose(1, 2)
    attn = torch.where(mask[None, None], qh @ kh.transpose(-1, -2), -1e9)
    attn = torch.softmax(attn, dim=-1)
    if attn_keep is not None:
        ak = attn_keep.reshape(n_head, p, tq, tk).transpose(0, 1)
        attn = attn * ak.float() * (1.0 / keep_prob)
    oh = attn @ vh                                    # [P, H, Tq, d_v] f32
    s = oh.sum(dim=1).mean(dim=1)
    gate = s @ sk_w.float() + sk_b.float()
    gate = torch.softmax(gate.reshape(p, n_head, d_v), dim=1)
    o = (oh * gate[:, :, None, :]).sum(dim=1).to(dt)
    y = o.reshape(p * tq, d_v).float() @ fc_w.float()
    if out_keep is not None:
        y = y * out_keep.float() * (1.0 / keep_prob)
    y = y.reshape(p, tq, d) + x_q.float()
    out = layer_norm_f32(y, ln_s, ln_b).to(dt)
    if not return_oh:
        return out
    res = (out, oh.transpose(0, 1).reshape(n_head, p * tq, d_v))
    if return_qkv:
        def heads(x, t, dh):
            return x.transpose(0, 1).reshape(n_head, p * t, dh)

        res += ((heads(qh, tq, d_k), heads(kh, tk, d_k),
                 heads(vh, tk, d_v)),)
    return res


def short_core(x_q, proj, sk_w, sk_b, fc_w, ln_s, ln_b, mask, tk, oh=None,
               qkv=None, drop=_NO_DROP):
    """The core kernel of csrc/sh_attention.cu on `project`'s f32 q, k, v:
    out [P, Tq, D] in x_q's dtype; writes the per-head outputs into `oh` and
    the save-qkv outputs into `qkv` where given.  Operands as `_check`
    leaves them; counts nothing (its callers do)."""
    p, tq, _ = x_q.shape
    out = torch.empty_like(x_q)
    lib = _build.load("sh_attention", _FUNCS)
    qkv_ptrs = [t.data_ptr() for t in qkv] if qkv is not None else [None] * 3
    _build.check(lib.sh_attention_fwd(
        int(x_q.dtype == torch.bfloat16), *(t.data_ptr() for t in proj),
        sk_w.data_ptr(), sk_b.data_ptr(), fc_w.data_ptr(), x_q.data_ptr(),
        ln_s.data_ptr(), ln_b.data_ptr(), mask.data_ptr(), out.data_ptr(),
        oh.data_ptr() if oh is not None else None, *qkv_ptrs, p, tq, tk,
        *drop, _build.stream_ptr(x_q.device)), "sh_attention_fwd")
    return out


def _forward(x_q, args, p, tq, tk, regime, oh=None, drop=_NO_DROP,
             save_qkv=False):
    """Launch the regime's forward; returns (out, saved q/k/v or None).
    oh: the [H, P*Tq, d_v] f32 output (the general regime needs one as
    scratch at eval too and makes it).  The projections are dropped when it
    returns (at eval they are the call's largest transient)."""
    dev, dt = x_q.device, x_q.dtype
    qkv = None
    if save_qkv:
        qkv = (_f32(dev, KERNEL_HEADS, p * tq, KERNEL_DK),
               _f32(dev, KERNEL_HEADS, p * tk, KERNEL_DK),
               _f32(dev, KERNEL_HEADS, p * tk, KERNEL_DK))
    if not p:
        return torch.empty_like(x_q), qkv
    x_kv, wq, wk, wv, sk_w, sk_b, fc_w, ln_s, ln_b, mask = args[1:]
    proj = project(x_q, x_kv, wq, wk, wv)
    if regime == "short":
        return short_core(x_q, proj, sk_w, sk_b, fc_w, ln_s, ln_b, mask, tk,
                          oh, qkv, drop), qkv
    out = torch.empty_like(x_q)
    qkv_ptrs = [t.data_ptr() for t in qkv] if save_qkv else [None] * 3
    if oh is None:
        oh = _f32(dev, KERNEL_HEADS, p * tq, KERNEL_DK)
    s, gate = _f32(dev, p, KERNEL_DK), _f32(dev, p, KERNEL_HEADS * KERNEL_DK)
    plan = general_plan(p, tq, tk, device_sms(dev))
    scratch = _general_scratch(dev, p, tq, plan)
    lib = _build.load("sh_attention_general", _GENERAL_FUNCS)
    _build.check(lib.sh_attention_general_fwd(
        int(dt == torch.bfloat16), *(t.data_ptr() for t in proj),
        sk_w.data_ptr(), sk_b.data_ptr(), fc_w.data_ptr(), x_q.data_ptr(),
        ln_s.data_ptr(), ln_b.data_ptr(), mask.data_ptr(), oh.data_ptr(),
        *qkv_ptrs, s.data_ptr(), gate.data_ptr(), out.data_ptr(),
        *_ptrs(scratch), p, tq, tk, plan.ksplits, plan.kchunk,
        plan.out_blocks, *drop, _build.stream_ptr(dev)),
        "sh_attention_general_fwd")
    return out, qkv


def _general_scratch(dev, p, tq, plan):
    """The general kernels' scratch of a call: the gate's row-sum partials
    [P, q tiles, H, d_v], and with key splits the splits' unnormalized
    outputs [ksplits, H, P*Tq, 64] and row statistics [ksplits, 2, H*P*Tq]
    (None without splits)."""
    colsum = _f32(dev, p, -(-tq // GENERAL_TILE), KERNEL_HEADS, KERNEL_DK)
    if plan.ksplits == 1:
        return colsum, None, None
    return (colsum, _f32(dev, plan.ksplits, KERNEL_HEADS, p * tq, KERNEL_DK),
            _f32(dev, plan.ksplits, 2, KERNEL_HEADS * p * tq))


def _ptrs(tensors):
    return [t.data_ptr() if t is not None else None for t in tensors]


def fused_sh_attention(x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w, ln_s, ln_b,
                       mask, n_head=8, d_k=64, d_v=64):
    """Same arguments and result as `sh_attention_reference` (no dropout:
    the eval kernel)."""
    if x_q.device.type == "cpu":
        return sh_attention_reference(x_q, x_kv, wq, wk, wv, sk_w, sk_b,
                                      fc_w, ln_s, ln_b, mask, n_head=n_head,
                                      d_k=d_k, d_v=d_v)
    p, tq, tk, _, _, args, regime = _check(
        "sh_attention", x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w, ln_s, ln_b,
        mask, n_head, d_k, d_v)
    out, _ = _forward(x_q, args, p, tq, tk, regime)
    if p:
        _count(fused_sh_attention, 1.0, regime)
    return out


_zero(fused_sh_attention, "launches", "general_launches")


def fused_sh_attention_saved(x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w, ln_s,
                             ln_b, mask, n_head=8, d_k=64, d_v=64, *,
                             attn_keep=None, out_keep=None, keep_prob=1.0,
                             seed=None, save_qkv=False):
    """(out, per-head outputs [H, P*Tq, d_v] f32): the forward of the train
    path, same arguments as `sh_attention_saved_reference`; with save_qkv
    (both sides <= 128 tokens) also the per-head (q / sqrt(d_k), k, v), each
    [H, P*T, d_k] f32, for `fused_sh_attention_bwd(qkv=...)`."""
    drop = dict(attn_keep=attn_keep, out_keep=out_keep, keep_prob=keep_prob,
                seed=seed)
    if x_q.device.type == "cpu":
        return sh_attention_saved_reference(x_q, x_kv, wq, wk, wv, sk_w, sk_b,
                                            fc_w, ln_s, ln_b, mask, n_head,
                                            d_k, d_v, save_qkv=save_qkv,
                                            **drop)
    p, tq, tk, _, _, args, regime = _check(
        "sh_attention_saved", x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w, ln_s,
        ln_b, mask, n_head, d_k, d_v)
    _build.require(not save_qkv or fuse_short(tq, tk),
                   "sh_attention_saved: q/k/v are saved only where both "
                   f"sides are <= {FUSE_MAX_TOKENS} tokens")
    kdrop = _kernel_drop("sh_attention_saved", x_q, p, tq, tk, **drop)
    oh = _f32(x_q.device, n_head, p * tq, d_v)
    out, qkv = _forward(x_q, args, p, tq, tk, regime, oh, kdrop, save_qkv)
    if p:
        _count(fused_sh_attention_saved, keep_prob, regime, save_qkv)
    return (out, oh, qkv) if save_qkv else (out, oh)


_zero(fused_sh_attention_saved, *_TRAIN_COUNTS)


def sh_attention_bwd_reference(x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w, ln_s,
                               ln_b, mask, oh, g, n_head=8, d_k=64, d_v=64, *,
                               attn_keep=None, out_keep=None, keep_prob=1.0,
                               seed=None, qkv=None):
    """Plain backward: torch autograd through `sh_attention_reference`
    (the saved per-head outputs `oh` and projections `qkv` are not needed).
    Returns the cotangents of (x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w, ln_s,
    ln_b)."""
    ak, ok = _plain_masks(attn_keep, out_keep, keep_prob, seed, x_q.shape[0],
                          x_q.shape[1], x_kv.shape[1], x_q.shape[2], n_head)

    def f(*a):
        return sh_attention_reference(*a, mask, n_head=n_head, d_k=d_k,
                                      d_v=d_v, attn_keep=ak, out_keep=ok,
                                      keep_prob=keep_prob)

    return vjp_of(f, (x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w, ln_s, ln_b),
                  g)


def _heads(x, p, t, n_head, dh, saved):
    """[P, H, T, dh] f32 from a projection [P*T, H*dh] or, saved, from the
    heads-major [H, P*T, dh]."""
    if saved:
        return x.float().reshape(n_head, p, t, dh).transpose(0, 1)
    return x.float().reshape(p, t, n_head, dh).transpose(1, 2)


def sh_attention_bwd_pairs_reference(q, k, v, sk_w, sk_b, fc_w, x_q, ln_s,
                                     mask, oh, g, n_head=8, d_k=64, d_v=64, *,
                                     qkv_saved=False, attn_keep=None,
                                     out_keep=None, keep_prob=1.0,
                                     seed=None):
    """Plain version of `short_bwd_pairs`, the per-pair kernel's outputs:
    (dy [P*Tq, D], o [P*Tq, d_v], s [P, d_v], dlogit [P, H*d_v], LayerNorm
    partials [2, P, D], dz [P*Tq, H*d_k], dk, dv [P*Tk, H*d_k], dy0 [P*Tq,
    D]), all f32, from the projections q, k, v (`project`'s, q unscaled; or
    with qkv_saved the forward's saved q / sqrt(d_k), k, v [H, P*T, d_k]),
    the saved per-head outputs oh [H, P*Tq, d_v] and the output cotangent g.
    The Pallas kernel's cast points (pallas_attention.py:474-627): f32
    between the products, the gated head sum rounded to x_q's dtype before
    fc, the LayerNorm in f32; dy0 = dy * out_keep / keep_prob (dy without
    dropout)."""
    p, tq, d = x_q.shape
    tk = k.shape[-2] // p if qkv_saved else k.shape[0] // p
    dt = x_q.dtype
    attn_keep, out_keep = _plain_masks(attn_keep, out_keep, keep_prob, seed,
                                       p, tq, tk, d, n_head)
    ohh = oh.float().reshape(n_head, p, tq, d_v)
    # 1. the gate, as the forward built it
    u = ohh[0]
    for h in range(1, n_head):
        u = u + ohh[h]
    s = u.sum(dim=1) / tq                                     # [P, d_v]
    gate = torch.softmax((s @ sk_w.float() + sk_b.float())
                         .reshape(p, n_head, d_v), dim=1)      # [P, H, d_v]
    o = ohh[0] * gate[:, 0, None, :]
    for h in range(1, n_head):
        o = o + ohh[h] * gate[:, h, None, :]
    o = o.reshape(p * tq, d_v).to(dt).float()
    # 2. fc, the output dropout, the residual, the LayerNorm and back
    okf = (out_keep.float() * (1.0 / keep_prob) if out_keep is not None
           else None)
    y0 = o @ fc_w.float()
    y = (y0 * okf if okf is not None else y0) + x_q.reshape(p * tq, d).float()
    mu = y.mean(dim=-1, keepdim=True)
    rs = torch.rsqrt(((y - mu) ** 2).mean(dim=-1, keepdim=True) + LN_EPS)
    xhat = (y - mu) * rs
    g32 = g.reshape(p * tq, d).float()
    lnp = torch.stack([(g32 * xhat).reshape(p, tq, d).sum(dim=1),
                       g32.reshape(p, tq, d).sum(dim=1)])
    dxhat = g32 * ln_s.float()
    dy = rs * (dxhat - dxhat.mean(dim=-1, keepdim=True) -
               xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
    dy0 = dy * okf if okf is not None else dy
    do = (dy0 @ fc_w.float().t()).reshape(p, tq, d_v)
    # 3. the gate backward
    dgate = torch.stack([(do * ohh[h]).sum(dim=1) for h in range(n_head)], 1)
    gdot = (gate * dgate).sum(dim=1, keepdim=True)
    dlogit = (gate * (dgate - gdot)).reshape(p, n_head * d_v)
    du = (dlogit @ sk_w.float().t()) / tq                     # [P, d_v]
    # 4. per head
    qh = _heads(q, p, tq, n_head, d_k, qkv_saved)
    if not qkv_saved:
        qh = qh / (d_k ** 0.5)
    kh = _heads(k, p, tk, n_head, d_k, qkv_saved)
    vh = _heads(v, p, tk, n_head, d_v, qkv_saved)
    doh = do[:, None] * gate[:, :, None, :] + du[:, None, None, :]
    probs = torch.softmax(torch.where(mask[None, None], qh @ kh.transpose(-1, -2),
                                      -1e9), dim=-1)
    dprobs = doh @ vh.transpose(-1, -2)
    pd = probs
    if attn_keep is not None:
        akf = (attn_keep.float().reshape(n_head, p, tq, tk).transpose(0, 1) *
               (1.0 / keep_prob))
        pd, dprobs = probs * akf, dprobs * akf
    dv = pd.transpose(-1, -2) @ doh
    ds = probs * (dprobs - (probs * dprobs).sum(dim=-1, keepdim=True))
    dz = ds @ kh / (d_k ** 0.5)
    dk = ds.transpose(-1, -2) @ qh

    def flat(x, t):
        return x.transpose(1, 2).reshape(p * t, -1)

    return (dy, o, s, dlogit, lnp, flat(dz, tq), flat(dk, tk), flat(dv, tk),
            dy0)


def bwd_products(x_q, x_kv, wq, wk, wv, pairs_out):
    """The products that follow the per-pair part, on csrc/gemm.cu (its
    plain version for CPU tensors): from `short_bwd_pairs`'s outputs (or its
    plain version's), the cotangents of (x_q, x_kv, wq, wk, wv, sk_w, sk_b,
    fc_w, ln_s, ln_b), the weights' in their dtype:
    dxq = dy + dz wq^T, dxkv = dk wk^T + dv wv^T, dwq = x_q^T dz, dwk =
    x_kv^T dk, dwv = x_kv^T dv, dsk_w = s^T dlogit, dfc_w = o^T dy0, and
    column sums for dsk_b, dln_s and dln_b."""
    dy, o, s, dgl, lnp, dz, dk, dv, dy0 = pairs_out
    p, tq, d = x_q.shape
    tk = x_kv.shape[1]
    dt = x_q.dtype
    gemm, NT, TN = _gemm.gemm, _gemm.NT, _gemm.TN
    xq2, xkv2 = x_q.reshape(p * tq, d), x_kv.reshape(p * tk, d)
    dxq = gemm(NT, dz, wq, cadd=dy).to(dt).view(p, tq, d)
    dxkv = gemm(NT, dk, wk)
    dxkv = gemm(NT, dv, wv, cadd=dxkv, out=dxkv).to(dt).view(p, tk, d)
    # o is rounded to x's dtype where the kernels write it: as bf16 (an
    # exact cast) its product with dy0 takes the tensor cores
    return (dxq, dxkv, gemm(TN, xq2, dz, out_dtype=dt),
            gemm(TN, xkv2, dk, out_dtype=dt),
            gemm(TN, xkv2, dv, out_dtype=dt), gemm(TN, s, dgl, out_dtype=dt),
            _gemm.colsum(dgl).to(dt), gemm(TN, o.to(dt), dy0, out_dtype=dt),
            _gemm.colsum(lnp[0]), _gemm.colsum(lnp[1]))


# the per-head products of the per-pair kernel: each f32 operand in three
# bf16 terms (`_gemm.split3`), the six term products with i + j <= 2 summed
# in f32.  Its error against the exact product, element by element, is held
# (on the CPU for this emulation, on the card for the kernel's products) to
# SPLIT_BOUND * sum_k |a_ik| |b_kj| where the products are normal f32
# numbers.  The dropped terms are below 2^-23 of |a| |b|, so the error is
# the f32 sums' (the emulation 1.4e-7 to 6.4e-7 of the scale on the inputs
# of tests/test_torch_bwd_redesign.py and chip_smoke.py, the kernel 1.1e-6
# on an H100); the three-term split (i + j <= 1) drops terms up to 3 * 2^-18
# and reaches 1.5e-5 to 2.3e-5 there on all but normal-distributed pairs,
# so the bound lies between the two
SPLIT_BOUND = 2.0 ** -17


def split6_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [.., M, K] @ b [.., K, N] as the per-pair kernel's mma.sync
    products compute it: sum over i + j <= 2 of a_i @ b_j, smallest terms
    first, the terms as f32."""
    at = [x.float() for x in _gemm.split3(a)]
    bt = [x.float() for x in _gemm.split3(b)]
    out = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32,
                      device=a.device)
    for i, j in ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)):
        out = out + at[i] @ bt[j]
    return out


def split_check(a: torch.Tensor, b: torch.Tensor, ta=False, tb=False):
    """op(a) @ op(b) for [n, 64, 64] f32 a and b (op a transpose where ta /
    tb) through the per-pair kernel's own product code
    (`sh_attention_split_check`); `split6_matmul` on the CPU."""
    if a.device.type == "cpu":
        return split6_matmul(a.transpose(-1, -2) if ta else a,
                             b.transpose(-1, -2) if tb else b)
    req = _build.require
    req(a.shape == b.shape and a.dim() == 3 and tuple(a.shape[1:]) == (64, 64)
        and a.dtype == b.dtype == torch.float32,
        "split_check: a and b must be float32 [n, 64, 64]")
    _build.require_operands("split_check", a.device, (a, b))
    out = torch.empty_like(a)
    lib = _build.load("sh_attention", _FUNCS)
    _build.check(lib.sh_attention_split_check(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0], int(ta),
        int(tb), _build.stream_ptr(a.device)), "sh_attention_split_check")
    return out


def short_bwd_pairs(x_q, proj, sk_w, sk_b, fc_w, ln_s, mask, oh, g, tk,
                    qkv_saved=False, drop=_NO_DROP):
    """The per-pair kernel of csrc/sh_attention.cu (`sh_attn_bwd_kernel`) on
    the projections (`project`'s, or with qkv_saved the forward's saved
    q/k/v): the outputs of `sh_attention_bwd_pairs_reference`, in f32 (dy0
    is dy itself without dropout).  Operands as `_check` leaves them
    (contiguous, 16-byte aligned: checked again here, since callers other
    than the wrapper pass them); counts nothing (its callers do)."""
    p, tq, d = x_q.shape
    dev = x_q.device
    _build.require_operands("sh_attention_bwd_pairs", dev,
                            (x_q, sk_w, sk_b, fc_w, ln_s, mask, oh, g) +
                            tuple(proj))
    dy, o, s, dgl, lnp = (_f32(dev, p * tq, d), _f32(dev, p * tq, KERNEL_DK),
                          _f32(dev, p, KERNEL_DK),
                          _f32(dev, p, KERNEL_HEADS * KERNEL_DK),
                          _f32(dev, 2, p, d))
    dz, dk, dv = _f32(dev, p * tq, d), _f32(dev, p * tk, d), _f32(dev, p * tk, d)
    dropout = drop[0] is not None or drop[1] is not None
    dy0 = _f32(dev, p * tq, d) if dropout else dy
    lib = _build.load("sh_attention", _FUNCS)
    _build.check(lib.sh_attention_bwd_pairs(
        int(x_q.dtype == torch.bfloat16),
        *(t.data_ptr() for t in (x_q, sk_w, sk_b, fc_w, ln_s, mask, oh, g) +
          tuple(proj)),
        int(qkv_saved), *(t.data_ptr() for t in (dy, o, s, dgl)),
        lnp[0].data_ptr(), lnp[1].data_ptr(), dz.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), p, tq, tk, *drop,
        dy0.data_ptr() if dropout else None, _build.stream_ptr(dev)),
        "sh_attention_bwd_pairs")
    return dy, o, s, dgl, lnp, dz, dk, dv, dy0


def _backward(x_q, args, oh, g, p, tq, tk, regime, kdrop=_NO_DROP, qkv=None):
    """Launch the regime's backward on operands `_check` passed: the
    projections (`project`, unless the forward saved q/k/v), the per-pair
    kernel(s) on them, then the products (`bwd_products`); returns the
    cotangents of args[:10].  Counts nothing (its caller does)."""
    if not p:
        return tuple(torch.zeros_like(t) for t in args[:10])
    dev, dt, d = x_q.device, x_q.dtype, x_q.shape[2]
    x_kv, wq, wk, wv, sk_w, sk_b, fc_w, ln_s, ln_b, mask = args[1:]
    n_head, d_v = KERNEL_HEADS, KERNEL_DK
    dropout = kdrop[0] is not None or kdrop[1] is not None
    proj = qkv if qkv is not None else project(x_q, x_kv, wq, wk, wv)
    if regime == "short":
        pairs_out = short_bwd_pairs(x_q, proj, sk_w, sk_b, fc_w, ln_s, mask,
                                    oh, g, tk, qkv is not None, kdrop)
    else:
        def f32(*shape):
            return _f32(dev, *shape)

        items = -(-tq // GENERAL_ROWS)
        dy, o, s, dgl, lnp = (f32(p * tq, d), f32(p * tq, d_v), f32(p, d_v),
                              f32(p, n_head * d_v), f32(2, p * items, d))
        dz, dk, dv = f32(p * tq, d), f32(p * tk, d), f32(p * tk, d)
        dy0 = f32(p * tq, d) if dropout else dy
        dy0_ptr = dy0.data_ptr() if dropout else None
        gate, dos, dgp, du, stats = (f32(p, n_head * d_v), f32(p * tq, d_v),
                                     f32(p * items, n_head * d_v),
                                     f32(p, d_v), f32(3, n_head * p * tq))
        plan = general_plan(p, tq, tk, device_sms(dev))
        scratch = _general_scratch(dev, p, tq, plan)
        dkv = f32(plan.qsplits, 2, p * tk, d) if plan.qsplits > 1 else None
        lib = _build.load("sh_attention_general", _GENERAL_FUNCS)
        _build.check(lib.sh_attention_general_bwd(
            int(dt == torch.bfloat16), int(qkv is not None),
            *(t.data_ptr() for t in proj),
            sk_w.data_ptr(), sk_b.data_ptr(), fc_w.data_ptr(),
            x_q.data_ptr(), ln_s.data_ptr(), mask.data_ptr(), oh.data_ptr(),
            g.data_ptr(), gate.data_ptr(), s.data_ptr(), dy.data_ptr(),
            dy0_ptr, o.data_ptr(), dos.data_ptr(), lnp[0].data_ptr(),
            lnp[1].data_ptr(), dgp.data_ptr(), dgl.data_ptr(), du.data_ptr(),
            stats.data_ptr(), dz.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_ptrs(scratch + (dkv,)), p, tq, tk, *plan, *kdrop,
            _build.stream_ptr(dev)), "sh_attention_general_bwd")
        pairs_out = (dy, o, s, dgl, lnp, dz, dk, dv, dy0)
    del proj
    return bwd_products(x_q, x_kv, wq, wk, wv, pairs_out)


def fused_sh_attention_bwd(x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w, ln_s,
                           ln_b, mask, oh, g, n_head=8, d_k=64, d_v=64, *,
                           attn_keep=None, out_keep=None, keep_prob=1.0,
                           seed=None, qkv=None):
    """Same arguments and result as `sh_attention_bwd_reference`; oh is the
    second output of `fused_sh_attention_saved` with the same dropout, g
    [P, Tq, D] in x_q's dtype, qkv its third output under save_qkv (else
    None: the projections are recomputed).

    Kernel path, with the Pallas kernel's f32-between-products numerics
    (pallas_attention.py:474-627).  The projections are `project`'s again
    (the forward's values), or the saved q/k/v.  The per-pair part rebuilds
    the gate and fc/LayerNorm from oh, runs the LayerNorm, fc and gate
    backward and, per head, the probabilities for dz, dk, dv;
    it writes dy (the LayerNorm input's cotangent), the gated output o, the
    gate's s and logit cotangent, and the per-head dz/dk/dv in f32: the
    persistent per-pair kernel in the short regime (`short_bwd_pairs`,
    csrc/sh_attention.cu), the tiled launches of
    csrc/sh_attention_general.cu in the general one.  The products over the
    pair batch then run on csrc/gemm.cu (`bwd_products`).
    With dropout the kernels regenerate (or read) the forward's masks and
    also write dy0 = dy * out_keep / keep_prob, fc's output cotangent
    ([P*Tq, 512] f32 more); without, dy0 is dy.  Weight cotangents come back
    in the weights' dtype, as JAX's."""
    drop = dict(attn_keep=attn_keep, out_keep=out_keep, keep_prob=keep_prob,
                seed=seed)
    if x_q.device.type == "cpu":
        return sh_attention_bwd_reference(x_q, x_kv, wq, wk, wv, sk_w, sk_b,
                                          fc_w, ln_s, ln_b, mask, oh, g,
                                          n_head=n_head, d_k=d_k, d_v=d_v,
                                          **drop)
    name = "sh_attention_bwd"
    p, tq, tk, d, dt, args, regime = _check(
        name, x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w, ln_s, ln_b, mask,
        n_head, d_k, d_v)
    kdrop = _kernel_drop(name, x_q, p, tq, tk, **drop)
    req = _build.require
    req(tuple(oh.shape) == (n_head, p * tq, d_v) and
        oh.dtype == torch.float32,
        f"{name}: oh must be float32 [H, P*Tq, d_v]")
    req(g.shape == x_q.shape and g.dtype == dt,
        f"{name}: g must be [P, Tq, D] in x_q's dtype")
    _build.require_operands(name, x_q.device, (oh, g))
    if qkv is not None:
        req(fuse_short(tq, tk), f"{name}: saved q/k/v are read only where "
            f"both sides are <= {FUSE_MAX_TOKENS} tokens")
        req(len(qkv) == 3 and all(
            tuple(t.shape) == (n_head, p * n, d_k) and
            t.dtype == torch.float32 for t, n in zip(qkv, (tq, tk, tk))),
            f"{name}: qkv must be three float32 [H, P*T, d_k] tensors")
        _build.require_operands(name, x_q.device, qkv)
    grads = _backward(x_q, args, oh, g, p, tq, tk, regime, kdrop, qkv)
    if p:
        _count(fused_sh_attention_bwd, keep_prob, regime, qkv is not None)
    return grads


_zero(fused_sh_attention_bwd, *_TRAIN_COUNTS)


class FusedSHAttention(torch.autograd.Function):
    """`fused_sh_attention_saved` with `fused_sh_attention_bwd` as its
    backward; the dropout arguments reach both.  Under the save-qkv policy
    (`_SAVE_QKV`, short sides only) the forward's q/k/v go to the backward
    too.  Self-attention passes one tensor as x_q and x_kv; autograd sums
    its two cotangents."""

    @staticmethod
    def forward(ctx, x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w, ln_s, ln_b,
                mask, n_head, d_k, d_v, keep_prob, seed, attn_keep, out_keep):
        drop = dict(keep_prob=keep_prob, seed=seed, attn_keep=attn_keep,
                    out_keep=out_keep)
        save = _save_qkv_ok(x_q.shape[1], x_kv.shape[1])
        out, oh, *rest = fused_sh_attention_saved(
            x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w, ln_s, ln_b, mask,
            n_head, d_k, d_v, save_qkv=save, **drop)
        ctx.save_for_backward(x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w, ln_s,
                              ln_b, mask, oh, *(rest[0] if save else ()))
        ctx.heads = (n_head, d_k, d_v)
        ctx.drop = drop
        return out

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        grads = fused_sh_attention_bwd(
            *saved[:12], g.contiguous(), *ctx.heads,
            qkv=tuple(saved[12:]) or None, **ctx.drop)
        return tuple(grads) + (None,) * 8


def sh_attention(x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w, ln_s, ln_b, mask,
                 n_head=8, d_k=64, d_v=64, *, keep_prob=1.0, seed=None,
                 attn_keep=None, out_keep=None):
    """The model's fused attention block: the differentiable Function when
    an input needs a gradient or dropout is on, else the eval kernel."""
    args = (x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w, ln_s, ln_b, mask)
    if keep_prob < 1.0 or (torch.is_grad_enabled() and
                           any(t.requires_grad for t in args[:10])):
        return FusedSHAttention.apply(*args, n_head, d_k, d_v, keep_prob,
                                      seed, attn_keep, out_keep)
    return fused_sh_attention(*args, n_head, d_k, d_v)


def fused_sh_attention_rngdrop(x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w, ln_s,
                               ln_b, mask, seed, n_head=8, d_k=64, d_v=64,
                               keep_prob=0.9):
    """The attention block with dropout drawn in the kernels from `seed`
    ([2] int32), differentiable (pallas_attention.py:891)."""
    return sh_attention(x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w, ln_s, ln_b,
                        mask, n_head, d_k, d_v, keep_prob=keep_prob, seed=seed)


def fused_sh_attention_dropout(x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w, ln_s,
                               ln_b, mask, attn_keep, out_keep, n_head=8,
                               d_k=64, d_v=64, keep_prob=0.9):
    """The attention block with dropout from the operand masks attn_keep
    [H, P*Tq, Tk] and out_keep [P*Tq, D], differentiable
    (pallas_attention.py:817)."""
    return sh_attention(x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w, ln_s, ln_b,
                        mask, n_head, d_k, d_v, keep_prob=keep_prob,
                        attn_keep=attn_keep, out_keep=out_keep)
