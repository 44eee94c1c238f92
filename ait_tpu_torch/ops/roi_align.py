"""ROI Align (counterpart of ait_tpu/ops/roi_align.py).

Semantics of the reference CUDA kernel (ROIAlign_cuda.cu:64-122): no
half-pixel shift and no rounding of roi coordinates; rois are at least 1x1;
samples with y < -1 or y > H contribute zero, y in [-1, 0] clamps to 0; and
with `sampling_ratio <= 0` the adaptive grid, g = ceil(roi_extent /
out_size) samples per bin and axis.  Bilinear sampling with the per-axis
sample average folded in is separable:

    out[r, i, j, c] = Wy[r, i, h] * feat[h, w, c] * Wx[r, j, w]

`roi_align_reference` is the plain version: two dense interpolation
matrices per roi contracted against each image's map in two einsums (the
JAX package computes it the same way with XLA, outside any kernel).
`roi_align_cuda` is the wrapper of csrc/roi_align.cu, one launch for the
batch, with no TPU counterpart.  `roi_align` picks: a CPU tensor, or a
call that needs a gradient (the training forward: the kernel has no
backward, so the gradient flows through the einsums), goes to the plain
version; every other call goes to the kernel, whose wrapper refuses a map
it cannot read (not bf16 or f32, channels not in 8s).  It counts the
rois each route took (`roi_align.kernel_rois`, `roi_align.plain_rois`,
utils/profiling.count: Python ints from the shapes, no sync).
"""

from __future__ import annotations

import ctypes

import torch

from ait_tpu_torch.ops import _build
from ait_tpu_torch.utils.profiling import count


def _interp_weights(start, bin_size, n_bins, n_samples, size, grid=None):
    """[R, n_bins, size] bilinear weights with the sample average folded in.

    start, bin_size: [R]; grid: optional [R] per-roi sample count (adaptive
    mode): samples s >= grid[r] are masked out and the fold divides by
    grid[r]."""
    dev = start.device
    iy = torch.arange(n_bins * n_samples, dtype=torch.float32, device=dev)
    ph = torch.div(iy, n_samples, rounding_mode="floor")
    s = torch.remainder(iy, n_samples)
    if grid is None:
        denom = torch.tensor(float(n_samples), device=dev)
        valid = None
    else:
        denom = grid.to(torch.float32)[:, None]
        valid = s[None, :] < denom
    pos = start[:, None] + ph[None, :] * bin_size[:, None] + (
        (s[None, :] + 0.5) * bin_size[:, None] / denom)            # [R, I]
    out_of_range = (pos < -1.0) | (pos > size)
    pos = pos.clamp(0.0, size - 1.0)
    low = torch.floor(pos)
    frac = pos - low
    grid_ax = torch.arange(size, dtype=torch.float32, device=dev)
    grid_ax = grid_ax[None, None, :]
    w = (grid_ax == low[..., None]) * (1.0 - frac[..., None]) + (
        grid_ax == (low[..., None] + 1.0)) * frac[..., None]
    w = torch.where(out_of_range[..., None], 0.0, w)
    if valid is not None:
        w = torch.where(valid[..., None], w, 0.0)
    r = w.shape[0]
    w = w.reshape(r, n_bins, n_samples, size)
    if grid is None:
        return w.mean(dim=2)
    return w.sum(dim=2) / denom[..., None]


def roi_align_reference(feat: torch.Tensor, rois: torch.Tensor, *,
                        out_size: int = 7, spatial_scale: float = 1.0 / 16.0,
                        sampling_ratio: int = 0) -> torch.Tensor:
    """The plain version.  feat [B, H, W, C]; rois [B, R, 4] (x1, y1, x2, y2
    in image coords, clipped to the image) -> [B, R, out_size, out_size, C]
    in feat's dtype."""
    _, hh, ww, _ = feat.shape
    adaptive = sampling_ratio <= 0
    sy = -(-hh // out_size) if adaptive else sampling_ratio
    sx = -(-ww // out_size) if adaptive else sampling_ratio
    outs = []
    for fm, rb in zip(feat, rois.to(torch.float32)):
        x1 = rb[:, 0] * spatial_scale
        y1 = rb[:, 1] * spatial_scale
        x2 = rb[:, 2] * spatial_scale
        y2 = rb[:, 3] * spatial_scale
        roi_w = torch.clamp(x2 - x1, min=1.0)
        roi_h = torch.clamp(y2 - y1, min=1.0)
        bw = roi_w / out_size
        bh = roi_h / out_size
        if adaptive:
            gy = torch.ceil(bh).clamp(1, sy)
            gx = torch.ceil(bw).clamp(1, sx)
        else:
            gy = gx = None
        wy = _interp_weights(y1, bh, out_size, sy, hh, gy).to(fm.dtype)
        wx = _interp_weights(x1, bw, out_size, sx, ww, gx).to(fm.dtype)
        # contract the larger spatial axis first; the intermediate stays in
        # the compute dtype, as in the JAX package
        if ww >= hh:
            t = torch.einsum("rjw,hwc->rjhc", wx, fm)
            o = torch.einsum("rih,rjhc->rijc", wy, t)
        else:
            t = torch.einsum("rih,hwc->riwc", wy, fm)
            o = torch.einsum("rjw,riwc->rijc", wx, t)
        outs.append(o)
    return torch.stack(outs)


# the storage types the kernel reads and writes (csrc/roi_align.cu)
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)
# its largest output side, and the shared memory its weight rows may take
_MAX_OUT, _SMEM_BYTES = 7, 48 * 1024

_FUNCS = {"roi_align_fwd": [ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, ctypes.c_int, ctypes.c_float,
                            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                            ctypes.c_void_p]}


def roi_align_cuda(feat: torch.Tensor, rois: torch.Tensor, *,
                   out_size: int = 7, spatial_scale: float = 1.0 / 16.0,
                   sampling_ratio: int = 0) -> torch.Tensor:
    """csrc/roi_align.cu: `roi_align_reference`'s function in one launch,
    f32 weights and sums, the output rounded once to feat's dtype.  feat
    [B, H, W, C] bf16 or f32 on a CUDA device, C % 8 == 0; rois [B, R, 4]
    (a view with unit stride along the 4 coordinates is read in place).
    No autograd.  Counts one launch."""
    req = _build.require
    req(feat.dim() == 4 and feat.dtype in _KERNEL_DTYPES,
        "roi_align: feat must be bf16 or f32 [B, H, W, C]")
    b, hh, ww, c = feat.shape
    req(c % 8 == 0, "roi_align: the kernel takes channels in groups of 8")
    req(feat.is_cuda, "roi_align: the kernel runs on CUDA tensors")
    req(rois.dim() == 3 and rois.shape[0] == b and rois.shape[2] == 4,
        "roi_align: rois must be [B, R, 4]")
    req(rois.device == feat.device, "roi_align: rois on feat's device")
    req(1 <= out_size <= _MAX_OUT,
        f"roi_align: the kernel's output side is 1-{_MAX_OUT}")
    req(out_size * (hh + ww) * 4 <= _SMEM_BYTES,
        "roi_align: the map's weight rows exceed the kernel's shared memory")
    feat = feat.contiguous()
    _build.require_operands("roi_align", feat.device, (feat,))
    rois = rois.to(torch.float32)
    if rois.stride(2) != 1:
        rois = rois.contiguous()
    r = rois.shape[1]
    out = torch.empty((b, r, out_size, out_size, c), dtype=feat.dtype,
                      device=feat.device)
    if out.numel():
        lib = _build.load("roi_align", _FUNCS)
        _build.check(lib.roi_align_fwd(
            feat.data_ptr(), rois.data_ptr(), rois.stride(0), rois.stride(1),
            b, r, hh, ww, c, out_size, float(spatial_scale),
            int(sampling_ratio), int(feat.dtype == torch.bfloat16),
            out.data_ptr(), _build.stream_ptr(feat.device)), "roi_align_fwd")
        roi_align_cuda.launches += 1
    return out


roi_align_cuda.launches = 0


def roi_align(feat: torch.Tensor, rois: torch.Tensor, *, out_size: int = 7,
              spatial_scale: float = 1.0 / 16.0,
              sampling_ratio: int = 0) -> torch.Tensor:
    """feat [B, H, W, C]; rois [B, R, 4] (x1, y1, x2, y2 in image coords,
    clipped to the image) -> [B, R, out_size, out_size, C] in feat's dtype.
    The plain version for a CPU tensor or a call that needs a gradient,
    else the kernel (which raises for a map it cannot read)."""
    n = rois.shape[0] * rois.shape[1]
    grad = torch.is_grad_enabled() and (feat.requires_grad or
                                        rois.requires_grad)
    if feat.device.type == "cpu" or grad:
        count("roi_align.plain_rois", n)
        return roi_align_reference(feat, rois, out_size=out_size,
                                   spatial_scale=spatial_scale,
                                   sampling_ratio=sampling_ratio)
    count("roi_align.kernel_rois", n)
    return roi_align_cuda(feat, rois, out_size=out_size,
                          spatial_scale=spatial_scale,
                          sampling_ratio=sampling_ratio)
