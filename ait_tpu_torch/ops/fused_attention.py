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
CUDA kernel csrc/sh_attention.cu (which replaces ait_tpu/ops/
pallas_attention.py:746 fused_sh_attention): a CUDA tensor goes to the
kernel, a CPU tensor to the plain version.

Training (dropout 0):
* `fused_sh_attention_saved` is the same kernel that also writes each
  head's f32 attention output [H, P*Tq, d_v], exactly what its gate
  consumed (replaces the `save_oh` forward, pallas_attention.py:760 `_fwd`);
* `fused_sh_attention_bwd` is the backward from those saved outputs
  (replaces pallas_attention.py:630 `_fused_bwd_call`): the per-pair part in
  csrc/sh_attention.cu, the projections' input and weight gradients on
  csrc/gemm.cu.  Its plain version, `sh_attention_bwd_reference`, is torch
  autograd through `sh_attention_reference`;
* `FusedSHAttention` is the autograd Function over the two, and
  `sh_attention` what the model calls: the Function when an input needs a
  gradient, else the eval kernel, which writes no per-head outputs.
"""

from __future__ import annotations

import ctypes

import torch

from ait_tpu_torch.ops import _build, _gemm

LN_EPS = 1e-6

# the kernel's compiled widths (the flagship AIT head) and the longest
# sequence whose 8 per-head outputs fit in one block's shared memory
KERNEL_D, KERNEL_HEADS, KERNEL_DK, KERNEL_MAX_TOKENS = 512, 8, 64, 64


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


def sh_attention_reference(x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w, ln_s,
                           ln_b, mask, n_head=8, d_k=64, d_v=64, *,
                           return_oh=False):
    """x_q [P, Tq, D], x_kv [P, Tk, D], weights in the JAX layout ([in, out],
    x @ w), ln_s/ln_b f32, mask [Tq, Tk] bool (True = attend).  With
    return_oh, also the per-head attention outputs [H, P*Tq, d_v] in f32."""
    p, tq, d = x_q.shape
    tk = x_kv.shape[1]
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
    o32 = torch.einsum("phts,phsd->phtd", attn.to(v.dtype).float(),
                       v.float())
    o = o32.to(v.dtype)
    u = o.sum(dim=1)
    s = u.mean(dim=1)
    gate = (s @ sk_w + sk_b).reshape(p, n_head, d_v)
    gate = torch.softmax(gate.float(), dim=1).to(o.dtype)
    o = (o * gate[:, :, None, :]).sum(dim=1)
    y = (o.reshape(p * tq, d_v) @ fc_w).reshape(p, tq, d)
    y = y + x_q
    out = layer_norm_f32(y.float(), ln_s, ln_b).to(x_q.dtype)
    if return_oh:
        return out, o32.transpose(0, 1).reshape(n_head, p * tq, d_v)
    return out


def sh_attention_saved_reference(x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w,
                                 ln_s, ln_b, mask, n_head=8, d_k=64, d_v=64):
    """Plain version of `fused_sh_attention_saved`: (out, per-head outputs
    [H, P*Tq, d_v] f32)."""
    return sh_attention_reference(x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w,
                                  ln_s, ln_b, mask, n_head, d_k, d_v,
                                  return_oh=True)


_FUNCS = {"sh_attention_fwd": [ctypes.c_int] + [ctypes.c_void_p] * 13 +
          [ctypes.c_int] * 3 + [ctypes.c_void_p],
          "sh_attention_bwd_pairs": [ctypes.c_int] + [ctypes.c_void_p] * 21 +
          [ctypes.c_int] * 3 + [ctypes.c_void_p]}


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
    req(1 <= tq <= KERNEL_MAX_TOKENS and 1 <= tk <= KERNEL_MAX_TOKENS,
        f"{name}: sequences must be 1..{KERNEL_MAX_TOKENS} tokens")
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
    return p, tq, tk, d, dt, args


def _forward(x_q, args, p, tq, tk, oh):
    out = torch.empty_like(x_q)
    if p:
        lib = _build.load("sh_attention", _FUNCS)
        _build.check(lib.sh_attention_fwd(
            int(x_q.dtype == torch.bfloat16), *(t.data_ptr() for t in args),
            out.data_ptr(), oh.data_ptr() if oh is not None else None, p,
            tq, tk, _build.stream_ptr(x_q.device)), "sh_attention_fwd")
    return out


def fused_sh_attention(x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w, ln_s, ln_b,
                       mask, n_head=8, d_k=64, d_v=64):
    """Same arguments and result as `sh_attention_reference`."""
    if x_q.device.type == "cpu":
        return sh_attention_reference(x_q, x_kv, wq, wk, wv, sk_w, sk_b,
                                      fc_w, ln_s, ln_b, mask, n_head=n_head,
                                      d_k=d_k, d_v=d_v)
    p, tq, tk, _, _, args = _check(
        "sh_attention", x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w, ln_s, ln_b,
        mask, n_head, d_k, d_v)
    out = _forward(x_q, args, p, tq, tk, None)
    if p:
        fused_sh_attention.launches += 1
    return out


fused_sh_attention.launches = 0


def fused_sh_attention_saved(x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w, ln_s,
                             ln_b, mask, n_head=8, d_k=64, d_v=64):
    """(out, per-head outputs [H, P*Tq, d_v] f32): the forward of the train
    path, same arguments as `fused_sh_attention`."""
    if x_q.device.type == "cpu":
        return sh_attention_saved_reference(x_q, x_kv, wq, wk, wv, sk_w, sk_b,
                                            fc_w, ln_s, ln_b, mask, n_head,
                                            d_k, d_v)
    p, tq, tk, _, _, args = _check(
        "sh_attention_saved", x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w, ln_s,
        ln_b, mask, n_head, d_k, d_v)
    oh = torch.empty((n_head, p * tq, d_v), dtype=torch.float32,
                     device=x_q.device)
    out = _forward(x_q, args, p, tq, tk, oh)
    if p:
        fused_sh_attention_saved.launches += 1
    return out, oh


fused_sh_attention_saved.launches = 0


def sh_attention_bwd_reference(x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w, ln_s,
                               ln_b, mask, oh, g, n_head=8, d_k=64, d_v=64):
    """Plain backward: torch autograd through `sh_attention_reference`
    (the saved per-head outputs `oh` are not needed).  Returns the
    cotangents of (x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w, ln_s, ln_b)."""
    def f(*a):
        return sh_attention_reference(*a, mask, n_head=n_head, d_k=d_k,
                                      d_v=d_v)

    return vjp_of(f, (x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w, ln_s, ln_b),
                  g)


def fused_sh_attention_bwd(x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w, ln_s,
                           ln_b, mask, oh, g, n_head=8, d_k=64, d_v=64):
    """Same arguments and result as `sh_attention_bwd_reference`; oh is the
    second output of `fused_sh_attention_saved`, g [P, Tq, D] in x_q's dtype.

    Kernel path, with the Pallas kernel's f32-between-products numerics
    (pallas_attention.py:474-627): one block per pair rebuilds the gate and
    fc/LayerNorm from oh, runs the LayerNorm, fc and gate backward and, per
    head, recomputes q/k/v and the probabilities for dz, dk, dv; it writes
    dy (the LayerNorm input's cotangent), the gated output o, the gate's s
    and logit cotangent, and the per-head dz/dk/dv in f32.  The products
    over the pair batch then run on csrc/gemm.cu: dxq = dy + dz wq^T,
    dxkv = dk wk^T + dv wv^T, dwq = xq^T dz, dwk = xkv^T dk, dwv = xkv^T dv,
    dfc_w = o^T dy, dsk_w = s^T dlogit; column sums give dsk_b, dln_s and
    dln_b.  Weight cotangents come back in the weights' dtype, as JAX's."""
    if x_q.device.type == "cpu":
        return sh_attention_bwd_reference(x_q, x_kv, wq, wk, wv, sk_w, sk_b,
                                          fc_w, ln_s, ln_b, mask, oh, g,
                                          n_head=n_head, d_k=d_k, d_v=d_v)
    p, tq, tk, d, dt, args = _check(
        "sh_attention_bwd", x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w, ln_s,
        ln_b, mask, n_head, d_k, d_v)
    req = _build.require
    req(tuple(oh.shape) == (n_head, p * tq, d_v) and
        oh.dtype == torch.float32,
        "sh_attention_bwd: oh must be float32 [H, P*Tq, d_v]")
    req(g.shape == x_q.shape and g.dtype == dt,
        "sh_attention_bwd: g must be [P, Tq, D] in x_q's dtype")
    _build.require_operands("sh_attention_bwd", x_q.device, (oh, g))
    if not p:
        return tuple(torch.zeros_like(t) for t in args[:10])
    dev = x_q.device

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    dy, o, s, dgl, lnp = (f32(p * tq, d), f32(p * tq, d_v), f32(p, d_v),
                          f32(p, n_head * d_v), f32(2, p, d))
    dz, dk, dv = f32(p * tq, d), f32(p * tk, d), f32(p * tk, d)
    lib = _build.load("sh_attention", _FUNCS)
    _build.check(lib.sh_attention_bwd_pairs(
        int(dt == torch.bfloat16),
        *(t.data_ptr() for t in args[:9] + (mask, oh, g, dy, o, s, dgl)),
        lnp[0].data_ptr(), lnp[1].data_ptr(), dz.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), p, tq, tk, _build.stream_ptr(dev)),
        "sh_attention_bwd_pairs")
    gemm, NT, TN = _gemm.gemm, _gemm.NT, _gemm.TN
    xq2, xkv2 = x_q.view(p * tq, d), x_kv.view(p * tk, d)
    dxq = gemm(NT, dz, wq, cadd=dy).to(dt).view(p, tq, d)
    dxkv = gemm(NT, dk, wk)
    dxkv = gemm(NT, dv, wv, cadd=dxkv, out=dxkv).to(dt).view(p, tk, d)
    grads = (dxq, dxkv, gemm(TN, xq2, dz).to(dt), gemm(TN, xkv2, dk).to(dt),
             gemm(TN, xkv2, dv).to(dt), gemm(TN, s, dgl).to(dt),
             _gemm.colsum(dgl).to(dt), gemm(TN, o, dy).to(dt),
             _gemm.colsum(lnp[0]), _gemm.colsum(lnp[1]))
    fused_sh_attention_bwd.launches += 1
    return grads


fused_sh_attention_bwd.launches = 0


class FusedSHAttention(torch.autograd.Function):
    """`fused_sh_attention_saved` with `fused_sh_attention_bwd` as its
    backward.  Self-attention passes one tensor as x_q and x_kv; autograd
    sums its two cotangents."""

    @staticmethod
    def forward(ctx, x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w, ln_s, ln_b,
                mask, n_head, d_k, d_v):
        out, oh = fused_sh_attention_saved(x_q, x_kv, wq, wk, wv, sk_w,
                                           sk_b, fc_w, ln_s, ln_b, mask,
                                           n_head, d_k, d_v)
        ctx.save_for_backward(x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w, ln_s,
                              ln_b, mask, oh)
        ctx.heads = (n_head, d_k, d_v)
        return out

    @staticmethod
    def backward(ctx, g):
        grads = fused_sh_attention_bwd(*ctx.saved_tensors, g.contiguous(),
                                       *ctx.heads)
        return tuple(grads) + (None,) * 4


def sh_attention(x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w, ln_s, ln_b, mask,
                 n_head=8, d_k=64, d_v=64):
    """The model's fused attention block: the differentiable Function when
    an input needs a gradient, else the eval kernel."""
    args = (x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w, ln_s, ln_b, mask)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args[:10]):
        return FusedSHAttention.apply(*args, n_head, d_k, d_v)
    return fused_sh_attention(*args, n_head, d_k, d_v)
