"""Box delta decode and clipping (counterpart of ait_tpu/ops/boxes.py).

The reference's Caffe-era conventions: widths and heights carry a `+1`
(bbox_transform.py:16-20) and clipping clamps to `size - 1`
(bbox_transform.py:125-133).  Every function broadcasts over leading axes.
"""

from __future__ import annotations

import torch


def _whctr(boxes):
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h
    return w, h, cx, cy


def bbox_transform_inv(boxes: torch.Tensor,
                       deltas: torch.Tensor) -> torch.Tensor:
    """Decode deltas against boxes.  [..., 4] x [..., 4] -> [..., 4]."""
    w, h, cx, cy = _whctr(boxes)
    pcx = deltas[..., 0] * w + cx
    pcy = deltas[..., 1] * h + cy
    pw = torch.exp(deltas[..., 2]) * w
    ph = torch.exp(deltas[..., 3]) * h
    return torch.stack(
        [pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw, pcy + 0.5 * ph],
        dim=-1)


def clip_boxes(boxes: torch.Tensor, im_hw: torch.Tensor) -> torch.Tensor:
    """Clamp boxes to [0, W-1] x [0, H-1]; im_hw (..., 2) = (height, width)
    broadcastable against the box batch."""
    im_hw = im_hw.to(boxes.dtype)
    h = im_hw[..., 0]
    w = im_hw[..., 1]
    x1 = torch.minimum(boxes[..., 0].clamp(min=0.0), w - 1.0)
    y1 = torch.minimum(boxes[..., 1].clamp(min=0.0), h - 1.0)
    x2 = torch.minimum(boxes[..., 2].clamp(min=0.0), w - 1.0)
    y2 = torch.minimum(boxes[..., 3].clamp(min=0.0), h - 1.0)
    return torch.stack([x1, y1, x2, y2], dim=-1)
