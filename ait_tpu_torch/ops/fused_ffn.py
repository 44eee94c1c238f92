"""Fused position-wise FFN and positional-encoding + LayerNorm glue, forward
(counterpart of ait_tpu/ops/pallas_ffn.py).

* `fused_ffn`: relu(x @ w1 + b1) @ w2 + b2 -> + x -> LayerNorm, over flat
  rows [N, D]; the wrapper of csrc/ffn.cu, which replaces
  ait_tpu/ops/pallas_ffn.py:195 fused_ffn.
* `fused_posln`: LayerNorm(x + pos[i mod T]) over flat pair-major rows; the
  wrapper of csrc/posln.cu, which replaces ait_tpu/ops/pallas_ffn.py:355
  fused_posln.

Dropout is off on this (eval) path.  LayerNorm eps is 1e-6 with f32
statistics.  A CUDA tensor goes to the kernel, a CPU tensor to the plain
version beside it (`ffn_reference`, `posln_reference`).
"""

from __future__ import annotations

import ctypes

import torch

from ait_tpu_torch.ops import _build
from ait_tpu_torch.ops.fused_attention import layer_norm_f32

# the widths the kernels are compiled for (the flagship AIT head)
KERNEL_D, KERNEL_HIDDEN = 512, 2048


def ffn_reference(x, w1, b1, w2, b2, ln_s, ln_b):
    """x [N, D] in the compute dtype; w1 [D, H], w2 [H, D] in the JAX layout;
    biases and LayerNorm params f32."""
    dt = x.dtype
    # jnp.dot(..., preferred_element_type=f32): exact products, f32 sums
    y1 = x.float() @ w1.to(dt).float() + b1
    y1 = y1.clamp(min=0.0).to(dt)
    y2 = y1.float() @ w2.to(dt).float() + b2
    y = y2 + x.float()
    return layer_norm_f32(y, ln_s, ln_b).to(dt)


def posln_reference(x, pos, ln_s, ln_b):
    """x [N, D] flat pair-major rows, pos [T, D] with N % T == 0 (row i gets
    position i % T)."""
    t = pos.shape[0]
    n = x.shape[0]
    y = x.float() + pos.float().repeat(n // t, 1)
    return layer_norm_f32(y, ln_s, ln_b).to(x.dtype)


def _check_rows(name, x, params):
    req = _build.require
    req(x.is_cuda, f"{name}: the kernel runs on CUDA tensors")
    req(x.dtype in (torch.float32, torch.bfloat16),
        f"{name}: the kernel takes float32 or bfloat16")
    req(x.dim() == 2 and x.shape[1] == KERNEL_D,
        f"{name}: x must be [N, {KERNEL_D}]")
    _build.require_operands(name, x.device, (x,) + tuple(params))


_FFN_FUNCS = {"ffn_fwd": [ctypes.c_int] + [ctypes.c_void_p] * 8 +
              [ctypes.c_int, ctypes.c_void_p]}
_POSLN_FUNCS = {"posln_fwd": [ctypes.c_int] + [ctypes.c_void_p] * 5 +
                [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]}


def fused_ffn(x, w1, b1, w2, b2, ln_s, ln_b):
    """Same arguments and result as `ffn_reference`; on CUDA w1 and w2 must
    already be in x's dtype."""
    if x.device.type == "cpu":
        return ffn_reference(x, w1, b1, w2, b2, ln_s, ln_b)
    _check_rows("ffn", x, (w1, b1, w2, b2, ln_s, ln_b))
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
            ln_b.data_ptr(), out.data_ptr(), x.shape[0],
            _build.stream_ptr(x.device)), "ffn_fwd")
        fused_ffn.launches += 1
    return out


fused_ffn.launches = 0


def fused_posln(x, pos, ln_s, ln_b):
    """Same arguments and result as `posln_reference`; on CUDA pos must be
    in x's dtype."""
    if x.device.type == "cpu":
        return posln_reference(x, pos, ln_s, ln_b)
    _check_rows("posln", x, (pos, ln_s, ln_b))
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
        lib = _build.load("posln", _POSLN_FUNCS)
        _build.check(lib.posln_fwd(
            int(x.dtype == torch.bfloat16), x.data_ptr(), pos.data_ptr(),
            ln_s.data_ptr(), ln_b.data_ptr(), out.data_ptr(), n, t,
            _build.stream_ptr(x.device)), "posln_fwd")
        fused_posln.launches += 1
    return out


fused_posln.launches = 0
