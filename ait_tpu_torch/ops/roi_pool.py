"""ROI max-pool, POOLING_MODE 'pool' (counterpart of ait_tpu/ops/roi_pool.py).

Semantics of the reference CUDA kernel (ROIPool_cuda.cu:17-78) as the JAX
package reads them: roi coordinates rounded to the feature grid
(round(x * spatial_scale), half to even), bin edges floor / ceil over the
rounded roi in exact integer arithmetic (`_bin_edges`), bins clipped to the
map, an empty bin gives 0.  The max is separable (rows, then columns); each
bin is a window of at most ceil(size / out_size) + 1 grid lines, so a bin
is a clamped gather of that many lines and a masked max.

Plain PyTorch: the JAX package computes it with XLA, outside any kernel.
The backward is autograd's max (one argmax per bin; JAX's max splits a tie
evenly).
"""

from __future__ import annotations

import torch

NEG = -1e30


def _bin_edges(start, end, n_bins: int, size: int):
    """Inclusive-exclusive bin edges [R, n_bins] as f32: floor(k * L / n)
    and ceil((k + 1) * L / n) in integers, offset by start, clipped to
    [0, size]."""
    length = torch.clamp(end - start + 1.0, min=1.0).to(torch.int32)
    start = start.to(torch.int32)
    k = torch.arange(n_bins, dtype=torch.int32, device=start.device)
    lo = (k[None, :] * length[:, None]) // n_bins + start[:, None]
    hi = (((k[None, :] + 1) * length[:, None] + n_bins - 1) // n_bins
          + start[:, None])
    return (lo.clamp(0, size).to(torch.float32),
            hi.clamp(0, size).to(torch.float32))


def _window_max(x, lo, hi, k: int, axis_size: int, per_roi: bool):
    """The masked max over the k entries from lo along x's window axis
    (lo, hi [R]): x is [S, ...] shared by the rois, or with per_roi
    [R, S, ...]; returns [R, ...]."""
    offs = torch.arange(k, dtype=torch.float32, device=lo.device)
    pos = lo[:, None] + offs[None, :]                     # [R, k]
    idx = pos.clamp(0, axis_size - 1).to(torch.int64)
    if per_roi:
        gathered = x[torch.arange(x.shape[0], device=x.device)[:, None], idx]
    else:
        gathered = x[idx]                                 # [R, k, ...]
    valid = (pos < hi[:, None]).reshape(
        pos.shape + (1,) * (gathered.dim() - 2))
    return torch.where(valid, gathered,
                       gathered.new_full((), NEG)).amax(dim=1)


def roi_pool(feat: torch.Tensor, rois: torch.Tensor, *, out_size: int = 7,
             spatial_scale: float = 1.0 / 16.0) -> torch.Tensor:
    """feat [B, H, W, C]; rois [B, R, 4] (x1, y1, x2, y2, image coords) ->
    [B, R, out_size, out_size, C] max-pooled, in feat's dtype."""
    _, hh, ww, _ = feat.shape
    k_h = -(-hh // out_size) + 1
    k_w = -(-ww // out_size) + 1
    outs = []
    for fm, rb in zip(feat, rois.to(torch.float32)):
        x1 = torch.round(rb[:, 0] * spatial_scale)
        y1 = torch.round(rb[:, 1] * spatial_scale)
        x2 = torch.round(rb[:, 2] * spatial_scale)
        y2 = torch.round(rb[:, 3] * spatial_scale)
        lo_y, hi_y = _bin_edges(y1, y2, out_size, hh)       # [R, P]
        lo_x, hi_x = _bin_edges(x1, x2, out_size, ww)
        r = rb.shape[0]
        f32 = fm.to(torch.float32)                          # [H, W, C]
        rows = torch.stack([
            _window_max(f32, lo_y[:, ph], hi_y[:, ph], k_h, hh, False)
            for ph in range(out_size)], dim=1)              # [R, P, W, C]
        rows_t = rows.permute(0, 2, 1, 3).reshape(r, ww, -1)  # [R, W, P*C]
        cells = torch.stack([
            _window_max(rows_t, lo_x[:, pw], hi_x[:, pw], k_w, ww, True)
            for pw in range(out_size)], dim=1)              # [R, P, P*C]
        out = cells.reshape(r, out_size, out_size, -1).permute(0, 2, 1, 3)
        out = torch.where(out <= NEG / 2, out.new_zeros(()), out)
        outs.append(out.to(fm.dtype))
    return torch.stack(outs)
