"""Launchers of csrc/gemm.cu: the f32-accumulating product (tensor cores
where an operand is bf16, an f32 operand in three bf16 terms; FMA tiles for
f32 x f32) and the fixed-order column sum that the backward kernels'
wrappers (ops/fused_ffn.py, ops/fused_attention.py) are built from.

`gemm` takes its plain version, `gemm_reference`, for CPU tensors only; a
CUDA tensor goes to the kernel or raises.  It counts a tensor-core launch in
`gemm.launches` and an FMA-tile launch in `gemm.fma_launches`.
"""

from __future__ import annotations

import ctypes

import torch

from ait_tpu_torch.ops import _build

NN, NT, TN = 0, 1, 2

_I, _P = ctypes.c_int, ctypes.c_void_p
_FUNCS = {"gemm": [_I] * 6 + [_P, _P, _I, _P, _P, _P, _P, _I, _I, _P, _I, _P],
          "colsum": [_P, _I, _I, _I, _P, _P, _P]}

# tensor cores: 128 x 128 output tiles, 64-deep k-stages, one block per SM;
# split K (the weight gradients) until the waves fill >= 90% of the SMs,
# keeping >= 8 k-stages per split
_TC_TILE, _TC_DEPTH = 128, 64
_FULL_WAVES = 0.9
_MIN_STAGES_PER_SPLIT = 8
_MAX_SPLITS = 64
# FMA tiles (64 x 64): split K until about this many blocks are in flight
_TARGET_BLOCKS = 1024
_MIN_SPLIT_K = 512


def _lib():
    return _build.load("gemm", _FUNCS)


def _dtype_flag(t, name):
    _build.require(t.dtype in (torch.float32, torch.bfloat16),
                   f"gemm: {name} must be float32 or bfloat16")
    return int(t.dtype == torch.bfloat16)


def _shape(layout, a, b):
    """(M, N, K, K of b) of the product."""
    if layout == TN:
        (k, m), (k2, n) = a.shape, b.shape
    elif layout == NT:
        (m, k), (n, k2) = a.shape, b.shape
    else:
        (m, k), (k2, n) = a.shape, b.shape
    return m, n, k, k2


def split3(v: torch.Tensor):
    """(hi, mid, lo) bf16 with hi + mid + lo == v exactly for finite f32 v
    with |v| >= 2^-110 (below it lo, a bf16 subnormal there, loses the bits
    under 2^-133); hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid).
    An infinite hi (|v| >= 2^128 (1 - 2^-9), or v infinite) gives a nan mid
    and lo; a nan stays nan.  The kernel splits its f32 operands so."""
    v = v.float()
    hi = v.to(torch.bfloat16)
    r = v - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def gemm_reference(layout: int, a: torch.Tensor, b: torch.Tensor, *,
                   bias=None, cadd=None, mask=None, relu: bool = False,
                   out_dtype=torch.float32, out=None) -> torch.Tensor:
    """Plain version of `gemm`: the product of the f32 operands in torch,
    then the same epilogue; written into `out` when given."""
    a32, b32 = a.float(), b.float()
    if layout == TN:
        y = a32.t() @ b32
    elif layout == NT:
        y = a32 @ b32.t()
    else:
        y = a32 @ b32
    if bias is not None:
        y = y + bias
    if cadd is not None:
        y = y + cadd
    if relu:
        y = torch.relu(y)
    if mask is not None:
        y = torch.where(mask.float() > 0, y, torch.zeros_like(y))
    if out is None:
        return y.to(out_dtype)
    return out.copy_(y)


def tensor_core_path(a: torch.Tensor, b: torch.Tensor) -> bool:
    """A bf16 operand on either side takes the tensor cores."""
    return torch.bfloat16 in (a.dtype, b.dtype)


def tc_splits(m: int, n: int, k: int, sms: int) -> int:
    """Splits of K on the tensor-core path: the fewest whose waves of
    128 x 128 tiles fill >= 90% of the SMs (the most filled if none does),
    at most one per 8 k-stages."""
    tiles = -(-m // _TC_TILE) * -(-n // _TC_TILE)
    most = max(1, min(_MAX_SPLITS, -(-k // _TC_DEPTH) // _MIN_STAGES_PER_SPLIT))

    def fill(s):
        blocks = tiles * s
        return blocks / (-(-blocks // sms) * sms)

    best = max(range(1, most + 1), key=lambda s: (fill(s), -s))
    return next(s for s in range(1, most + 1)
                if fill(s) >= min(_FULL_WAVES, fill(best)))


def _fma_splits(layout, m, n, k):
    if layout != TN:
        return 1
    tiles = -(-m // 64) * -(-n // 64)
    return max(1, min(-(-_TARGET_BLOCKS // tiles), k // _MIN_SPLIT_K))


def gemm(layout: int, a: torch.Tensor, b: torch.Tensor, *, bias=None,
         cadd=None, mask=None, relu: bool = False,
         out_dtype=torch.float32, out=None) -> torch.Tensor:
    """NN: a [M, K] @ b [K, N];  NT: a [M, K] @ b[N, K]^T;  TN: a[K, M]^T @
    b [K, N].  Then + bias [N] (f32), + cadd [M, N] (f32, may be `out`),
    relu, and zero where mask [M, N] is not > 0; stored as out_dtype."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return gemm_reference(layout, a, b, bias=bias, cadd=cadd, mask=mask,
                              relu=relu, out_dtype=out_dtype, out=out)
    req = _build.require
    req(a.is_cuda and b.is_cuda and a.dim() == 2 and b.dim() == 2,
        "gemm: operands must be 2-D CUDA tensors")
    m, n, k, k2 = _shape(layout, a, b)
    req(k == k2, f"gemm: inner sizes differ ({tuple(a.shape)}, {tuple(b.shape)})")
    req(m > 0 and n > 0 and k > 0, "gemm: empty product")
    a_bf16, b_bf16 = _dtype_flag(a, "a"), _dtype_flag(b, "b")
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
    tc = tensor_core_path(a, b)
    if tc:
        # TMA reads rows of 16-byte multiples; the epilogue column pairs
        req(all(t.shape[1] * t.element_size() % 16 == 0 for t in (a, b))
            and n % 8 == 0,
            "gemm: on the tensor cores each operand's rows must be multiples "
            "of 16 bytes and N a multiple of 8")
        splits = tc_splits(m, n, k, torch.cuda.get_device_properties(
            a.device).multi_processor_count)
    else:
        splits = _fma_splits(layout, m, n, k)
    partial = (torch.empty((splits, m, n), dtype=torch.float32,
                           device=a.device) if splits > 1 else None)
    _build.check(_lib().gemm(
        layout, a_bf16, b_bf16, m, n, k, a.data_ptr(), b.data_ptr(), splits,
        partial.data_ptr() if partial is not None else None,
        bias.data_ptr() if bias is not None else None,
        cadd.data_ptr() if cadd is not None else None,
        mask.data_ptr() if mask is not None else None,
        int(mask is not None and mask.dtype == torch.bfloat16), int(relu),
        out.data_ptr(), int(out.dtype == torch.bfloat16),
        _build.stream_ptr(a.device)), "gemm")
    if tc:
        gemm.launches += 1
    else:
        gemm.fma_launches += 1
    return out


gemm.launches = gemm.fma_launches = 0


def colsum(x: torch.Tensor) -> torch.Tensor:
    """Column sums of an f32 [R, C] tensor, in a fixed order on the card
    (`x.sum(0)`, its plain version, for a CPU tensor)."""
    if x.device.type == "cpu":
        return x.float().sum(dim=0)
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
