"""ROI Align as two separable interpolation contractions (counterpart of
ait_tpu/ops/roi_align.py).

Semantics of the reference CUDA kernel (ROIAlign_cuda.cu:64-122): no
half-pixel shift and no rounding of roi coordinates; rois are at least 1x1;
samples with y < -1 or y > H contribute zero, y in [-1, 0] clamps to 0; and
with `sampling_ratio <= 0` the adaptive grid, g = ceil(roi_extent /
out_size) samples per bin and axis.  Bilinear sampling with the per-axis
sample average folded in becomes two dense interpolation matrices per roi,
contracted against the feature map:

    out[r, i, j, c] = Wy[r, i, h] * feat[h, w, c] * Wx[r, j, w]

This is plain PyTorch: the JAX package computes it with XLA, outside any
kernel.
"""

from __future__ import annotations

import torch


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


def roi_align(feat: torch.Tensor, rois: torch.Tensor, *, out_size: int = 7,
              spatial_scale: float = 1.0 / 16.0,
              sampling_ratio: int = 0) -> torch.Tensor:
    """feat [B, H, W, C]; rois [B, R, 4] (x1, y1, x2, y2 in image coords,
    clipped to the image) -> [B, R, out_size, out_size, C] in feat's dtype."""
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
