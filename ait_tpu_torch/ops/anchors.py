"""Anchor enumeration in numpy (counterpart of ait_tpu/ops/anchors.py).

The classic Faster R-CNN anchors: aspect ratios enumerated around a 16px
base window, then scales (reference lib/model/rpn/generate_anchors.py).
"""

from __future__ import annotations

import numpy as np


def _whctrs(anchor):
    w = anchor[2] - anchor[0] + 1
    h = anchor[3] - anchor[1] + 1
    return w, h, anchor[0] + 0.5 * (w - 1), anchor[1] + 0.5 * (h - 1)


def _mkanchors(ws, hs, x_ctr, y_ctr):
    ws = ws[:, None]
    hs = hs[:, None]
    return np.hstack(
        [x_ctr - 0.5 * (ws - 1), y_ctr - 0.5 * (hs - 1),
         x_ctr + 0.5 * (ws - 1), y_ctr + 0.5 * (hs - 1)]
    )


def generate_anchors(base_size: int = 16,
                     ratios=(0.5, 1.0, 2.0),
                     scales=(8, 16, 32)) -> np.ndarray:
    """[A, 4] base anchors around the (0,0,15,15) window."""
    ratios = np.asarray(ratios, np.float64)
    scales = np.asarray(scales, np.float64)
    base = np.array([1, 1, base_size, base_size], np.float64) - 1
    w, h, cx, cy = _whctrs(base)
    size = w * h
    ws = np.round(np.sqrt(size / ratios))
    hs = np.round(ws * ratios)
    ratio_anchors = _mkanchors(ws, hs, cx, cy)
    out = []
    for i in range(ratio_anchors.shape[0]):
        w, h, cx, cy = _whctrs(ratio_anchors[i])
        out.append(_mkanchors(w * scales, h * scales, cx, cy))
    return np.vstack(out).astype(np.float32)


def shifted_anchors(feat_h: int, feat_w: int, stride: int,
                    ratios=(0.5, 1.0, 2.0), scales=(8, 16, 32)) -> np.ndarray:
    """All anchors for a feature map: [H*W*A, 4] float32, row-major over
    (y, x, a): index = (y * W + x) * A + a."""
    base = generate_anchors(ratios=ratios, scales=scales)  # [A, 4]
    sx = np.arange(feat_w, dtype=np.float32) * stride
    sy = np.arange(feat_h, dtype=np.float32) * stride
    gx, gy = np.meshgrid(sx, sy)  # [H, W]
    shifts = np.stack([gx, gy, gx, gy], axis=-1).reshape(-1, 1, 4)
    return (shifts + base[None]).reshape(-1, 4)
