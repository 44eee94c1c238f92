"""Box delta encode/decode, clipping and IoU (counterpart of
ait_tpu/ops/boxes.py).

The reference's Caffe-era conventions: widths and heights carry a `+1`
(bbox_transform.py:16-20), clipping clamps to `size - 1`
(bbox_transform.py:125-133), and the batched IoU masks zero-padded gt boxes
to 0 and zero-area candidate boxes to -1 (bbox_transform.py:195-213).
Every function broadcasts over leading axes.
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


def bbox_transform(ex_rois: torch.Tensor,
                   gt_rois: torch.Tensor) -> torch.Tensor:
    """Encode gt boxes as deltas w.r.t. example rois.  [..., 4] -> [..., 4]."""
    ew, eh, ecx, ecy = _whctr(ex_rois)
    gw, gh, gcx, gcy = _whctr(gt_rois)
    dx = (gcx - ecx) / ew
    dy = (gcy - ecy) / eh
    dw = torch.log(gw / ew)
    dh = torch.log(gh / eh)
    return torch.stack([dx, dy, dw, dh], dim=-1)


def bbox_overlaps(boxes: torch.Tensor,
                  query_boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU with +1 areas.  [..., N, 4] x [..., K, 4] -> [..., N, K]."""
    b = boxes[..., :, None, :]
    q = query_boxes[..., None, :, :]
    iw = (torch.minimum(b[..., 2], q[..., 2]) -
          torch.maximum(b[..., 0], q[..., 0]) + 1.0).clamp(min=0.0)
    ih = (torch.minimum(b[..., 3], q[..., 3]) -
          torch.maximum(b[..., 1], q[..., 1]) + 1.0).clamp(min=0.0)
    area_b = ((boxes[..., 2] - boxes[..., 0] + 1.0) *
              (boxes[..., 3] - boxes[..., 1] + 1.0))
    area_q = ((query_boxes[..., 2] - query_boxes[..., 0] + 1.0) *
              (query_boxes[..., 3] - query_boxes[..., 1] + 1.0))
    inter = iw * ih
    union = area_b[..., :, None] + area_q[..., None, :] - inter
    return inter / union


def _zero_box(boxes):
    return (((boxes[..., 2] - boxes[..., 0] + 1.0) == 1.0) &
            ((boxes[..., 3] - boxes[..., 1] + 1.0) == 1.0))


def bbox_overlaps_masked(boxes: torch.Tensor,
                         gt_boxes: torch.Tensor) -> torch.Tensor:
    """IoU with the reference's zero-padding sentinels: an all-zero gt box
    zeroes its column, an all-zero candidate box sets its row to -1."""
    iou = bbox_overlaps(boxes, gt_boxes)
    iou = torch.where(_zero_box(gt_boxes)[..., None, :], 0.0, iou)
    return torch.where(_zero_box(boxes)[..., :, None], -1.0, iou)
