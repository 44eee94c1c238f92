"""The comparison that decides `correct`: what the timed path produced,
judged by the plain float32 reference (reference/model.py).

A served batch is judged at four stages, so that a discrete choice (which
anchors survive NMS) never turns a rounding difference into a different
answer:

1. `rpn_gap`: the reference runs the backbone, the co-attention and the RPN
   head on the batch's inputs; the root-mean-square gap of the program's
   RPN logits from the reference's over the reference's RMS, and the same
   of the deltas, whichever is larger.
2. `roi_miss`: the reference's proposal layer (decode, clip, stable sort,
   exact greedy NMS) on the program's own RPN outputs must give the
   program's rois: the count of rois more than 0.01 px off.
3. `score_gap`, `box_gap`: the reference's head (ROI Align, transformer,
   SKNet, top, heads) on the program's rois, with the reference's own
   features.  The RMS gap of the program's match logit difference
   (log p / (1 - p), p its match probability) from the reference's l1 - l0,
   and of each box delta, each over the largest value that the head's
   linear layers give a vector of the reference's top output's size: the
   norm of the row of weights that makes the output times the RMS norm of
   its input vectors.  The outputs themselves are no scale: at the start of
   training the head's small weights make them differences of nearly equal
   terms, and their size swings by seed.
4. `det_miss`: the reference's postprocess (decode, clip, rescale, NMS,
   the per-image cap) of the program's rois, probabilities and deltas must
   give the program's detections: the count of detections with a
   coordinate or score off by more than 1e-4 of its magnitude (of 1 below
   1), or that one side lacks.

Gaps are RMS and not widest gaps: a widest gap over thousands of rois
swings from seed to seed by more than the control's margin.  A fault on
some rows still shows, as a gap far above rounding's or as a count.

Stages 2 and 4 follow the program from its own outputs at the stage
before, which they check by themselves; stages 1 and 3 are computed by
the reference from the inputs alone.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchlib.weights import make_weights
from reference import model as R
from reference.params import param_shapes

ROI_TOL_PX = 0.01
DET_TOL = 1e-4


def _rms(x) -> float:
    return float(x.double().pow(2).mean().sqrt())


def _rel_gap(got, want) -> float:
    want = want.float()
    return _rms(got.float() - want) / max(_rms(want), 1e-30)


def _logit(p):
    p = p.double().clamp(1e-12, 1 - 1e-12)
    return (torch.log(p) - torch.log1p(-p)).float()


def judge_serve(W, cfg, rec: Dict, chunk: int = 2) -> Dict[str, float]:
    """Numbers of one served batch.  rec holds the batch's inputs ('image',
    'query', 'im_info', numpy) and what the program produced: 'rpn_cls',
    'rpn_deltas', 'rois', 'cls_prob', 'bbox_pred' (tensors) and 'dets' (a
    list of [N, 5] numpy arrays)."""
    dev = rec["rois"].device
    image = torch.as_tensor(rec["image"], device=dev)
    query = torch.as_tensor(rec["query"], device=dev)
    info = torch.as_tensor(rec["im_info"], device=dev)
    with torch.no_grad():
        feats = R.features(W, cfg, image, query)
        rpn_gap = max(_rel_gap(rec["rpn_cls"], feats.rpn.cls_logits),
                      _rel_gap(rec["rpn_deltas"], feats.rpn.deltas))
        prog_rpn = R.RPN(rec["rpn_cls"].float(), rec["rpn_deltas"].float())
        rois = R.proposals(cfg, prog_rpn, info, train=False)
        off = (rois - rec["rois"].float()).abs().amax(dim=-1)
        roi_miss = int((off > ROI_TOL_PX).sum())
        h = R.head(W, cfg, feats, rec["rois"].float(), chunk=chunk)
        prob = rec["cls_prob"].float().reshape(h.prob.shape)
        score_gap, box_gap = head_gaps(W, h, prob, rec["bbox_pred"])
        dets, valid = R.postprocess(cfg, rec["rois"].float(), prob,
                                    rec["bbox_pred"].float(), info)
    return {"rpn_gap": rpn_gap, "roi_miss": roi_miss,
            "score_gap": score_gap, "box_gap": box_gap,
            "det_miss": det_miss(rec["dets"], dets, valid)}


def head_gaps(W, h, prob, bbox_pred):
    """(score_gap, box_gap) of the program's match probability [B, R] and
    box deltas [B, R, 4] against the reference head `h` (see the module's
    docstring)."""
    feats = torch.cat([h.pvec, h.qvec[:, None, :].expand_as(h.pvec)], -1)
    w1 = W["cls_score_1.weight"]
    v = W["cls_score_0.weight"].t() @ (w1[1] - w1[0])      # [4096]
    scale = float(v.norm()) * _rms(feats.norm(dim=-1))
    ref_d = h.logits[..., 1] - h.logits[..., 0]
    score_gap = _rms(_logit(prob) - ref_d) / max(scale, 1e-30)
    rows = W["bbox_pred_head.weight"].norm(dim=1)           # [4]
    scale = rows * _rms(h.pvec.norm(dim=-1))
    box_gap = _rms((bbox_pred.float().reshape(h.deltas.shape) - h.deltas) /
                   scale.clamp(min=1e-30))
    return score_gap, box_gap


def det_miss(got: List[np.ndarray], dets, valid) -> int:
    """Detections of `got` (one [N, 5] array per image) that the reference's
    (dets [B, R, 5] and valid [B, R]) lack, and the other way round."""
    miss = 0
    for i, g in enumerate(got):
        want = dets[i][valid[i]].cpu().numpy()
        g = np.asarray(g, np.float32).reshape(-1, 5)
        n = min(len(g), len(want))
        miss += abs(len(g) - len(want))
        if n:
            far = np.abs(g[:n] - want[:n]) > DET_TOL * np.maximum(
                1.0, np.abs(want[:n]))
            miss += int(far.any(axis=1).sum())
    return miss


def worst(per_batch: List[Dict[str, float]]) -> Dict[str, float]:
    """The worst reading of each number over the judged batches."""
    return {k: max(d[k] for d in per_batch) for k in per_batch[0]}


def control_record(W, cfg, batch: Dict, prec, device, chunk: int = 2
                   ) -> Dict:
    """What the reference at precision `prec` produces for a batch, in the
    form `judge_serve` takes: the control put in the program's place."""
    image = torch.as_tensor(batch["image"], device=device)
    query = torch.as_tensor(batch["query"], device=device)
    info = torch.as_tensor(batch["im_info"], device=device)
    with torch.no_grad():
        feats = R.features(W, cfg, image, query, prec)
        rois = R.proposals(cfg, feats.rpn, info, train=False)
        h = R.head(W, cfg, feats, rois, prec, chunk=chunk)
        dets, valid = R.postprocess(cfg, rois, h.prob, h.deltas, info)
    return {"rpn_cls": feats.rpn.cls_logits, "rpn_deltas": feats.rpn.deltas,
            "rois": rois, "cls_prob": h.prob[..., None],
            "bbox_pred": h.deltas,
            "dets": [dets[i][valid[i]].cpu().numpy()
                     for i in range(dets.shape[0])]}


# A leaf whose reference gradient is under this share of the median leaf's
# moves by round-off alone (a key's bias under softmax): it is left out.
NOUGHT_GRAD = 1e-3


def judge_train(cell, seed, batches, records, losses, buf1, params,
                gen_seed, device, detail=None) -> Dict[str, float]:
    """The first steps of a training run, judged by the reference following
    them from the same weights, batches and generator seed, and from the
    program's own rois (the proposal layer's output):

    - `loss_gap`: the widest of |loss - reference loss| / |reference loss|
      over the steps;
    - `grad_gap`: the first step's gradient as the optimizer got it (its
      momentum after one step, less the weight decay of the initial
      weights), by the worst leaf: | |g| - |g_ref| | over the larger of the
      leaf's reference norm and the median leaf's;
    - `update_gap`: the same of each leaf's change after the steps;
    - `grad_leaf_gap`, `update_leaf_gap`: the same two over the leaf's own
      reference norm alone, so that a fault confined to a leaf far smaller
      than the median one (a LayerNorm's scale, a bias) shows;
    - the stage followed, by itself, as a served batch's: `rpn_gap`, the
      RMS gap of the first step's RPN outputs from the reference's, and
      `roi_miss`, the rois of the reference's proposal layer (TRAIN tops)
      on the program's RPN outputs that differ from the program's.

    Leaves whose reference gradient is nought to rounding (under
    NOUGHT_GRAD of the median leaf's) are left out of the leaf gaps.  The
    reference takes its lrs from the configuration (reference.train.lrs),
    never from the program's schedule.  records: the program's
    proposal-layer captures, one a step.  A dict `detail` is given the
    five worst leaves of each leaf gap, with their norms over the median
    leaf's."""
    from reference import train as T

    cfg = cell.cfg
    W0 = make_weights(param_shapes(cfg), seed, device)
    W = {k: v.clone() for k, v in W0.items()}
    g = torch.Generator(device=device).manual_seed(gen_seed)
    rois = [r["rois"].float() for r in records]
    lrs = T.lrs(cell.config["train"], len(batches))
    ref_losses, ref_g, rpns = T.run_steps(
        W, cfg, batches, lambda k, rpn, info: rois[k], g, lrs)
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(losses, ref_losses))
    opt = T.SGD(cfg, {})
    keys = sorted(ref_g)
    gn = {k: float(ref_g[k].norm()) for k in keys}
    med = float(np.median([gn[k] for k in keys]))
    keys = [k for k in keys if gn[k] >= NOUGHT_GRAD * med]
    pg = {k: float((buf1[k].float() - opt.decay(k) * W0[k]).norm())
          if k in buf1 else 0.0 for k in keys}
    grad_gap = max(abs(pg[k] - gn[k]) / max(gn[k], med) for k in keys)
    dn = {k: float((W[k] - W0[k]).norm()) for k in keys}
    dmed = float(np.median([dn[k] for k in keys]))
    pd = {k: float((params[k].float() - W0[k]).norm()) for k in keys}
    update_gap = max(abs(pd[k] - dn[k]) / max(dn[k], dmed) for k in keys)
    own_g = {k: abs(pg[k] - gn[k]) / max(gn[k], 1e-30) for k in keys}
    own_d = {k: abs(pd[k] - dn[k]) / max(dn[k], 1e-30) for k in keys}
    if detail is not None:
        for name, own, norm, m in (("grad", own_g, gn, med),
                                   ("update", own_d, dn, dmed)):
            top = sorted(keys, key=own.get, reverse=True)[:5]
            detail[name] = [(k, own[k], norm[k] / m) for k in top]
    first = records[0]
    rpn_gap = max(_rel_gap(first["rpn_cls"], rpns[0].cls_logits),
                  _rel_gap(first["rpn_deltas"], rpns[0].deltas))
    info = torch.as_tensor(batches[0]["im_info"], device=device)
    with torch.no_grad():
        mine = R.proposals(cfg, R.RPN(first["rpn_cls"].float(),
                                      first["rpn_deltas"].float()),
                           info, train=True)
    off = (mine - rois[0]).abs().amax(dim=-1)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "update_gap": update_gap, "grad_leaf_gap": max(own_g.values()),
            "update_leaf_gap": max(own_d.values()), "rpn_gap": rpn_gap,
            "roi_miss": int((off > ROI_TOL_PX).sum())}

