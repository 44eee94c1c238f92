"""Launchers of csrc/gemm.cu: the tiled f32-accumulating product and the
fixed-order column sum that the backward kernels' wrappers
(ops/fused_ffn.py, ops/fused_attention.py) are built from.

They take CUDA tensors only: the backward wrappers call them on their kernel
path, and the plain versions of those wrappers never do.
"""

from __future__ import annotations

import ctypes

import torch

from ait_tpu_torch.ops import _build

NN, NT, TN = 0, 1, 2

_I, _P = ctypes.c_int, ctypes.c_void_p
_FUNCS = {"gemm": [_I] * 6 + [_P, _P, _I, _P, _P, _P, _P, _I, _I, _P, _I, _P],
          "colsum": [_P, _I, _I, _I, _P, _P, _P]}

# the weight gradients reduce over up to ~65k rows onto a few hundred output
# tiles: split K until about this many blocks are in flight
_TARGET_BLOCKS = 1024
_MIN_SPLIT_K = 512


def _lib():
    return _build.load("gemm", _FUNCS)


def _dtype_flag(t, name):
    _build.require(t.dtype in (torch.float32, torch.bfloat16),
                   f"gemm: {name} must be float32 or bfloat16")
    return int(t.dtype == torch.bfloat16)


def gemm(layout: int, a: torch.Tensor, b: torch.Tensor, *, bias=None,
         cadd=None, mask=None, relu: bool = False,
         out_dtype=torch.float32, out=None) -> torch.Tensor:
    """NN: a [M, K] @ b [K, N];  NT: a [M, K] @ b[N, K]^T;  TN: a[K, M]^T @
    b [K, N].  Then + bias [N] (f32), + cadd [M, N] (f32, may be `out`),
    relu, and zero where mask [M, N] is not > 0; stored as out_dtype."""
    req = _build.require
    req(a.is_cuda and b.is_cuda and a.dim() == 2 and b.dim() == 2,
        "gemm: operands must be 2-D CUDA tensors")
    if layout == TN:
        k, m = a.shape
        k2, n = b.shape
    elif layout == NT:
        m, k = a.shape
        n, k2 = b.shape
    else:
        m, k = a.shape
        k2, n = b.shape
    req(k == k2, f"gemm: inner sizes differ ({tuple(a.shape)}, {tuple(b.shape)})")
    req(m > 0 and n > 0 and k > 0, "gemm: empty product")
    if out is None:
        out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    for t, name, shape, dts in ((bias, "bias", (n,), (torch.float32,)),
                                (cadd, "cadd", (m, n), (torch.float32,)),
                                (mask, "mask", (m, n),
                                 (torch.float32, torch.bfloat16)),
                                (out, "out", (m, n),
                                 (torch.float32, torch.bfloat16))):
        if t is not None:
            req(tuple(t.shape) == shape and t.dtype in dts,
                f"gemm: {name} must be {shape} of {dts}")
    ops = [t for t in (a, b, bias, cadd, mask, out) if t is not None]
    _build.require_operands("gemm", a.device, ops)
    splits = 1
    if layout == TN:
        tiles = -(-m // 64) * -(-n // 64)
        splits = max(1, min(-(-_TARGET_BLOCKS // tiles), k // _MIN_SPLIT_K))
    partial = (torch.empty((splits, m, n), dtype=torch.float32,
                           device=a.device) if splits > 1 else None)
    _build.check(_lib().gemm(
        layout, _dtype_flag(a, "a"), _dtype_flag(b, "b"), m, n, k,
        a.data_ptr(), b.data_ptr(), splits,
        partial.data_ptr() if partial is not None else None,
        bias.data_ptr() if bias is not None else None,
        cadd.data_ptr() if cadd is not None else None,
        mask.data_ptr() if mask is not None else None,
        int(mask is not None and mask.dtype == torch.bfloat16), int(relu),
        out.data_ptr(), int(out.dtype == torch.bfloat16),
        _build.stream_ptr(a.device)), "gemm")
    return out


def colsum(x: torch.Tensor) -> torch.Tensor:
    """Column sums of an f32 [R, C] CUDA tensor, in a fixed order."""
    req = _build.require
    req(x.is_cuda and x.dim() == 2 and x.dtype == torch.float32,
        "colsum: x must be a 2-D float32 CUDA tensor")
    _build.require_operands("colsum", x.device, (x,))
    rows, cols = x.shape
    splits = max(1, min(256, rows // 64))
    scratch = torch.empty((splits, cols), dtype=torch.float32, device=x.device)
    out = torch.empty((cols,), dtype=torch.float32, device=x.device)
    _build.check(_lib().colsum(x.data_ptr(), rows, cols, splits,
                               scratch.data_ptr(), out.data_ptr(),
                               _build.stream_ptr(x.device)), "colsum")
    return out
