"""Operations and bytes of the work, from shapes alone, and the H100's
published peaks.

`model_flops` counts the convolutions and products of the plain reference
(reference/model.py) at a cell's shapes with torch's FlopCounterMode on the
meta device: the backbone on image and query, the co-attention, the RPN
head, and the transformer, SKNet, top and heads over every roi the proposal
layer hands on.  ROI Align's interpolation, NMS and the elementwise work
are outside the count.  With `train`, the backward that autograd runs is
counted too (the stem and FrozenBN are frozen).

`attn_bound_s` and `ffn_bound_s` are the least time one call of the fused
attention or FFN can take: every input byte read once and every output byte
written once at the HBM rate, the products at the bf16 tensor-core rate,
whichever is longer (the arithmetic of the program's chip_smoke.py,
frozen here).  The dropout's Philox draws are left out of the bound, so a
share of it can only read low.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W limit
PEAK_BF16_FLOP_S = 989e12
PEAK_HBM_BYTES_S = 3.35e12


def _count(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


def model_flops(cfg, canvas_hw, batch: int, rois: int, train: bool) -> int:
    """Operations of one batch of `batch` pairs on a canvas of canvas_hw
    (the RGB size), with `rois` rois per image."""
    from reference import model as R
    from reference.params import frozen, param_shapes

    dev = torch.device("meta")
    W = {k: torch.empty(s, device=dev, requires_grad=train and not frozen(k))
         for k, s in param_shapes(cfg).items()}
    h, w = canvas_hw
    q = cfg["model"]["channels"]
    side = cfg["TRAIN"]["query_size"]
    pool = cfg["POOLING_SIZE"]
    prec = R.F32
    variant = cfg["model"]["backbone"]

    def run():
        img = torch.empty(batch, 3, h, w, device=dev)
        qry = torch.empty(batch, 3, side, side, device=dev)
        fi = R.backbone(W, img, prec, variant)
        fq = R.backbone(W, qry, prec, variant)
        ni, nq = R.coattention(W, fi, fq, prec)
        rpn = R.rpn_head(W, ni, prec)
        # the head's input is ROI Align's output: a leaf of the same shape
        # that carries the gradient on to the features in training
        props = torch.empty(batch * rois, q, pool, pool, device=dev,
                            requires_grad=train)
        x = R.transformer(W, props, nq, prec, cfg)
        x = R.sk_block(W, "sk.sk_props", x, prec)
        pvec = R.top(W, x, prec, variant).reshape(batch, rois, -1)
        qvec = R.top(W, R.sk_block(W, "sk.sk_query", nq, prec), prec,
                     variant)
        deltas = R.dense(W, "bbox_pred_head", pvec, prec)
        stack = torch.cat([pvec, qvec[:, None, :].expand_as(pvec)], -1)
        logits = R.dense(W, "cls_score_1",
                         R.dense(W, "cls_score_0", stack, prec), prec)
        if train:
            loss = (logits.sum() + deltas.sum() + rpn.cls_logits.sum() +
                    rpn.deltas.sum())
            loss.backward()

    return _count(run)


def _bound(nbytes: float, flops: float) -> float:
    return max(nbytes / PEAK_HBM_BYTES_S, flops / PEAK_BF16_FLOP_S)


def attn_bound_s(mode: str, p: int, tq: int, tk: int, self_attn: bool,
                 d: int = 512, dk: int = 64, h: int = 8) -> float:
    """One fused attention call over p pairs of tq queries and tk keys:
    mode "eval" (inference), "saved" (the train forward, which also writes
    the per-head outputs) or "bwd" (its backward)."""
    n_in = p * (tq if self_attn else tq + tk) * d * 2
    w_bytes = (3 * d * d + dk * h * dk + h * dk + dk * d) * 2 + 2 * d * 4
    oh_bytes = h * p * tq * dk * 4
    proj = p * (2 * tq * d * d + 4 * tk * d * d)
    flops_f = proj + p * (4 * tq * tk * d + 2 * dk * h * dk + 2 * tq * dk * d)
    flops_b = proj + p * (10 * tq * tk * d + 6 * tq * dk * d +
                          4 * tq * d * d + 8 * tk * d * d)
    eval_bytes = n_in + w_bytes + tq * tk + p * tq * d * 2
    if mode == "eval":
        return _bound(eval_bytes, flops_f)
    if mode == "saved":
        return _bound(eval_bytes + oh_bytes, flops_f)
    if mode == "bwd":
        return _bound(n_in + w_bytes + oh_bytes + tq * tk + p * tq * d * 2 +
                      p * (tq + tk) * d * 2 + w_bytes, flops_b)
    raise ValueError(mode)


def ffn_bound_s(mode: str, n: int, d: int = 512, hid: int = 2048) -> float:
    """One fused FFN call over n rows: "fwd" or "bwd"."""
    if mode == "fwd":
        return _bound(n * d * 2 * 2 + 2 * d * hid * 2 + (hid + 3 * d) * 4,
                      4 * n * d * hid)
    if mode == "bwd":
        return _bound(3 * n * d * 2 + 4 * d * hid * 2 +
                      2 * (hid + 3 * d) * 4, 12 * n * d * hid)
    raise ValueError(mode)
