"""Detection post-processing over the whole batch (counterpart of
ait_tpu/evaluation/postprocess.py).

Un-normalize the box deltas, decode them against the rois, clip, rescale to
original image coordinates, drop padding rows and scores at or below the
threshold, NMS (TEST.NMS = 0.3, the NMS kernel's second call site), and cap
at max_per_image with the reference's tie-inclusive cut
(test_net_voc.py:392-450).  Rows are (x1, y1, x2, y2, score), descending
score, with a validity mask.
"""

from __future__ import annotations

import torch

from ait_tpu_torch.ops.boxes import bbox_transform_inv, clip_boxes
from ait_tpu_torch.ops.nms import batched_nms_topk


def postprocess_detections(rois, cls_prob, bbox_pred, im_info, *,
                           nms_thresh: float = 0.3, score_thresh: float = 0.0,
                           max_per_image: int = 100,
                           bbox_normalize_means=(0.0, 0.0, 0.0, 0.0),
                           bbox_normalize_stds=(0.1, 0.1, 0.2, 0.2)):
    """rois [B,R,5], cls_prob [B,R,1], bbox_pred [B,R,4], im_info [B,3] ->
    (dets [B, R, 5], valid [B, R]).

    When more than max_per_image survive, every score tied with the
    max_per_image-th highest is kept (the mask marks them).  The
    class-specific head's 8 columns are refused: ait_tpu's postprocess
    cannot take them either (ait_tpu/evaluation/postprocess.py:39)."""
    if bbox_pred.shape[-1] != 4:
        raise ValueError(
            f"postprocess takes class-agnostic box deltas [B, R, 4], got "
            f"{tuple(bbox_pred.shape)} (model.class_agnostic=False)")
    dev = rois.device
    means = torch.tensor(bbox_normalize_means, dtype=torch.float32,
                         device=dev)
    stds = torch.tensor(bbox_normalize_stds, dtype=torch.float32, device=dev)
    deltas = bbox_pred.float() * stds + means
    im_info = im_info.float()

    boxes = bbox_transform_inv(rois[..., 1:5].float(), deltas)
    boxes = clip_boxes(boxes, im_info[:, None, :2])
    boxes = boxes / im_info[:, None, 2:3]

    scores = cls_prob[..., 0].float()
    # padding rois (all-zero rows past the NMS survivors) are not detections
    real = (rois[..., 1:5] != 0).any(dim=-1)
    valid = real & (scores > score_thresh)

    r = boxes.shape[1]
    out_b, out_s, out_v = batched_nms_topk(
        boxes, scores, nms_thresh, pre_topk=r, post_topk=r, valid=valid)
    if r > max_per_image:
        n_valid = out_v.sum(dim=1)
        ranked = torch.where(out_v, out_s, -torch.inf)
        kth = torch.sort(ranked, dim=1).values[:, -max_per_image]
        cut = torch.where(n_valid > max_per_image, kth, -torch.inf)
        out_v = out_v & (out_s >= cut[:, None])
    dets = torch.cat([out_b, out_s[..., None]], dim=-1)
    return dets, out_v
