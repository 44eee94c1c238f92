"""Fused selective-head attention forward (counterpart of
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
"""

from __future__ import annotations

import ctypes

import torch

from ait_tpu_torch.ops import _build

LN_EPS = 1e-6

# the kernel's compiled widths (the flagship AIT head) and the longest
# sequence whose 8 per-head outputs fit in one block's shared memory
KERNEL_D, KERNEL_HEADS, KERNEL_DK, KERNEL_MAX_TOKENS = 512, 8, 64, 64


def layer_norm_f32(y: torch.Tensor, scale, bias) -> torch.Tensor:
    """LayerNorm of f32 rows with eps 1e-6, as the JAX package writes it."""
    mu = y.mean(dim=-1, keepdim=True)
    var = ((y - mu) ** 2).mean(dim=-1, keepdim=True)
    return (y - mu) * torch.rsqrt(var + LN_EPS) * scale + bias


def sh_attention_reference(x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w, ln_s,
                           ln_b, mask, *, n_head=8, d_k=64, d_v=64):
    """x_q [P, Tq, D], x_kv [P, Tk, D], weights in the JAX layout ([in, out],
    x @ w), ln_s/ln_b f32, mask [Tq, Tk] bool (True = attend)."""
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
    o = torch.einsum("phts,phsd->phtd", attn.to(v.dtype).float(),
                     v.float()).to(v.dtype)
    u = o.sum(dim=1)
    s = u.mean(dim=1)
    gate = (s @ sk_w + sk_b).reshape(p, n_head, d_v)
    gate = torch.softmax(gate.float(), dim=1).to(o.dtype)
    o = (o * gate[:, :, None, :]).sum(dim=1)
    y = (o.reshape(p * tq, d_v) @ fc_w).reshape(p, tq, d)
    y = y + x_q
    out = layer_norm_f32(y.float(), ln_s, ln_b)
    return out.to(x_q.dtype)


_FUNCS = {"sh_attention_fwd": [ctypes.c_int] + [ctypes.c_void_p] * 12 +
          [ctypes.c_int] * 3 + [ctypes.c_void_p]}


def fused_sh_attention(x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w, ln_s, ln_b,
                       mask, n_head=8, d_k=64, d_v=64):
    """Same arguments and result as `sh_attention_reference`."""
    if x_q.device.type == "cpu":
        return sh_attention_reference(x_q, x_kv, wq, wk, wv, sk_w, sk_b,
                                      fc_w, ln_s, ln_b, mask, n_head=n_head,
                                      d_k=d_k, d_v=d_v)
    req = _build.require
    req(x_q.is_cuda, "sh_attention: the kernel runs on CUDA tensors")
    p, tq, d = x_q.shape
    tk = x_kv.shape[1]
    dt = x_q.dtype
    req(dt in (torch.float32, torch.bfloat16),
        "sh_attention: the kernel takes float32 or bfloat16")
    req((d, n_head, d_k, d_v) ==
        (KERNEL_D, KERNEL_HEADS, KERNEL_DK, KERNEL_DK),
        "sh_attention: the kernel is built for D=512, 8 heads, d_k=d_v=64")
    req(1 <= tq <= KERNEL_MAX_TOKENS and 1 <= tk <= KERNEL_MAX_TOKENS,
        f"sh_attention: sequences must be 1..{KERNEL_MAX_TOKENS} tokens")
    req(x_kv.shape == (p, tk, d), "sh_attention: x_kv must be [P, Tk, D]")
    shapes = {"wq": (wq, (d, d)), "wk": (wk, (d, d)), "wv": (wv, (d, d)),
              "sk_w": (sk_w, (d_v, n_head * d_v)),
              "sk_b": (sk_b, (n_head * d_v,)), "fc_w": (fc_w, (d_v, d))}
    for name, (t, shape) in shapes.items():
        req(tuple(t.shape) == shape and t.dtype == dt,
            f"sh_attention: {name} must be {dt} {shape}")
    for name, t in (("ln_s", ln_s), ("ln_b", ln_b)):
        req(tuple(t.shape) == (d,) and t.dtype == torch.float32,
            f"sh_attention: {name} must be float32 [{d}]")
    req(mask.dtype == torch.bool and tuple(mask.shape) == (tq, tk),
        "sh_attention: mask must be bool [Tq, Tk]")
    args = (x_q, x_kv, wq, wk, wv, sk_w, sk_b, fc_w, ln_s, ln_b, mask)
    _build.require_operands("sh_attention", x_q.device, args)
    out = torch.empty_like(x_q)
    if p:
        lib = _build.load("sh_attention", _FUNCS)
        _build.check(lib.sh_attention_fwd(
            int(dt == torch.bfloat16), *(t.data_ptr() for t in args),
            out.data_ptr(), p, tq, tk, _build.stream_ptr(x_q.device)),
            "sh_attention_fwd")
        fused_sh_attention.launches += 1
    return out


fused_sh_attention.launches = 0
