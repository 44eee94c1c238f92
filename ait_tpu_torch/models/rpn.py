"""Region Proposal Network head and proposal layer (counterpart of
ait_tpu/models/rpn.py).

The head is a 3x3 conv, then 1x1 convs to 2A class logits and 4A deltas
(rpn.py:34-43); the logits split as [..., 2, A] (first A channels bg, next
A fg).  The proposal layer decodes and clips every anchor, forces anchors
centred beyond the true image (the padded part of the canvas) invalid, and
runs the batched top-k -> greedy NMS -> top-k (ops/nms.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ait_tpu_torch.models.layers import Conv, to_nchw, to_nhwc
from ait_tpu_torch.ops.boxes import bbox_transform_inv, clip_boxes
from ait_tpu_torch.ops.nms import batched_nms_topk


class RPNOut(NamedTuple):
    cls_logits: torch.Tensor   # [B, H, W, 2, A]
    bbox_deltas: torch.Tensor  # [B, H, W, A*4]


class RPNHead(nn.Module):
    def __init__(self, in_channels: int = 1024, num_anchors: int = 9,
                 mid_channels: int = 512, dtype=torch.float32):
        super().__init__()
        self.num_anchors = num_anchors
        self.conv = Conv(in_channels, mid_channels, 3, padding=1, dtype=dtype)
        self.cls_score = Conv(mid_channels, 2 * num_anchors, 1, dtype=dtype)
        self.bbox_pred = Conv(mid_channels, 4 * num_anchors, 1, dtype=dtype)

    def forward(self, feat):
        """feat [B, H, W, C] (NHWC) -> RPNOut."""
        x = torch.relu(self.conv(to_nchw(feat)))
        cls = to_nhwc(self.cls_score(x))
        bbox = to_nhwc(self.bbox_pred(x))
        b, h, w, _ = cls.shape
        return RPNOut(cls.reshape(b, h, w, 2, self.num_anchors), bbox)


def proposal_layer(rpn_out: RPNOut, anchors: torch.Tensor,
                   im_info: torch.Tensor, *, pre_nms_topk: int,
                   post_nms_topk: int, nms_thresh: float) -> torch.Tensor:
    """Anchors + deltas -> [B, post_nms_topk, 5] rois (batch index in col 0).

    anchors [H*W*A, 4] in the (y, x, a) order of the NHWC head outputs;
    im_info [B, 3] = (h, w, scale).  Proposals are data, not a
    differentiable path: the head outputs are detached here, as the JAX
    package stops their gradient (rpn.py:73-74)."""
    b, h, w, _, a = rpn_out.cls_logits.shape
    logits = rpn_out.cls_logits.detach().float()
    fg_prob = torch.softmax(logits, dim=3)[..., 1, :]
    scores = fg_prob.reshape(b, h * w * a)
    deltas = rpn_out.bbox_deltas.detach().float().reshape(b, h * w * a, 4)
    im_info = im_info.float()

    proposals = bbox_transform_inv(anchors[None], deltas)
    proposals = clip_boxes(proposals, im_info[:, None, :2])

    cx = 0.5 * (anchors[:, 0] + anchors[:, 2])
    cy = 0.5 * (anchors[:, 1] + anchors[:, 3])
    inside = ((cx[None] < im_info[:, None, 1]) &
              (cy[None] < im_info[:, None, 0]))

    boxes, _, _ = batched_nms_topk(proposals, scores, nms_thresh,
                                   pre_nms_topk, post_nms_topk, valid=inside)
    batch_idx = torch.arange(b, dtype=boxes.dtype, device=boxes.device)
    batch_idx = batch_idx[:, None, None].expand(b, post_nms_topk, 1)
    return torch.cat([batch_idx, boxes], dim=-1)
