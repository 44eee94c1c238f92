"""Operations of one served batch of query shots, from shapes alone.

`shots_flops` counts, as counts.model_flops does (torch's FlopCounterMode
over the plain reference on the meta device), the convolutions and
products of the shot-fused program: the image backbone at U images, the
query backbone at the U * A pairs, the non-local co-attention
(reference/coco.py) and the RPN head (the configuration's anchors) at the
pairs, and the transformer, SKNet, top and heads over every roi of every
pair.  ROI Align's interpolation, NMS, the gather of image features to
pairs and the elementwise work are outside the count.
"""

from __future__ import annotations

import torch

from benchlib.counts import _count


def shots_flops(cfg, canvas_hw, images: int, pairs: int, rois: int) -> int:
    """Operations of one batch of `images` canvases of canvas_hw (the RGB
    size) and `pairs` query shots over them, `rois` rois a pair."""
    from reference import coco as C
    from reference import model as R

    dev = torch.device("meta")
    W = {k: torch.empty(s, device=dev)
         for k, s in C.coco_param_shapes(cfg).items()}
    h, w = canvas_hw
    q = cfg["model"]["channels"]
    side = cfg["TRAIN"]["query_size"]
    pool = cfg["POOLING_SIZE"]
    prec = R.F32
    variant = cfg["model"]["backbone"]

    def run():
        img = torch.empty(images, 3, h, w, device=dev)
        qry = torch.empty(pairs, 3, side, side, device=dev)
        fi = R.backbone(W, img, prec, variant)
        fi = fi.repeat_interleave(pairs // images, dim=0)   # not counted
        fq = R.backbone(W, qry, prec, variant)
        ni, nq = C.nonlocal_coattention(W, fi, fq, prec)
        R.rpn_head(W, ni, prec, C.num_anchors(cfg))
        props = torch.empty(pairs * rois, q, pool, pool, device=dev)
        x = R.transformer(W, props, nq, prec, cfg)
        x = R.sk_block(W, "sk.sk_props", x, prec)
        pvec = R.top(W, x, prec, variant).reshape(pairs, rois, -1)
        qvec = R.top(W, R.sk_block(W, "sk.sk_query", nq, prec), prec,
                     variant)
        R.dense(W, "bbox_pred_head", pvec, prec)
        stack = torch.cat([pvec, qvec[:, None, :].expand_as(pvec)], -1)
        R.dense(W, "cls_score_1", R.dense(W, "cls_score_0", stack, prec),
                prec)

    return _count(run)
