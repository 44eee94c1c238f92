"""COCO bbox detection evaluation (counterpart of
ait_tpu/evaluation/coco_eval.py) — no pycocotools.

Replaces the reference's vendored pycocotools + `customCOCOeval`
(lib/datasets/coco.py:461-566, lib/pycocotools/cocoeval.py).  The environment
has no pycocotools wheel and the reference's Cython `_mask` is only needed for
segmentation, so bbox evaluation is reimplemented to the published COCO
protocol:

  * IoU thresholds 0.5:0.05:0.95, recall thresholds 0:0.01:1,
    area ranges all/small/medium/large, maxDets 1/10/100;
  * crowd gt: "IoU" uses the detection's own area as the union, matches to
    crowd count as ignore, a crowd gt can absorb many detections;
  * greedy per-detection matching in score order, preferring higher IoU and
    non-ignored gt;
  * precision envelope interpolated at the recall grid.

`summarize(class_index=...)` restricts the AP/AR means to the one-shot
split's classes exactly like customCOCOeval (coco.py:485-498).

The two inner loops (pairwise IoU-with-crowd and greedy matching) are the
JAX package's numpy versions (it sends them to its native C++ library when
that is built, with the same results).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np


def bbox_iou_xywh(dt: np.ndarray, gt: np.ndarray,
                  iscrowd: np.ndarray) -> np.ndarray:
    """Pairwise IoU of xywh boxes; crowd gt uses union = det area.

    The COCO convention (no +1): inter uses raw widths/heights.
    """
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dx1, dy1 = dt[:, 0], dt[:, 1]
    dx2, dy2 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    iw = np.minimum(dx2[:, None], gx2[None]) - np.maximum(dx1[:, None],
                                                          gx1[None])
    ih = np.minimum(dy2[:, None], gy2[None]) - np.maximum(dy1[:, None],
                                                          gy1[None])
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    da = (dt[:, 2] * dt[:, 3])[:, None]
    ga = (gt[:, 2] * gt[:, 3])[None]
    union = np.where(iscrowd[None].astype(bool), da, da + ga - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def greedy_match(ious: np.ndarray, gt_ignore: np.ndarray,
                 iscrowd: np.ndarray, thrs: np.ndarray):
    """Per-threshold greedy matching (cocoeval evaluateImg inner loop).

    ious: [D, G] with gt already sorted ignore-last; returns
    (dtm [T, D] matched gt index + 1 or 0, dt_ignore [T, D]).
    """
    # Greedy over detections is inherently sequential, but
    # the scan over gts is vectorized per detection.  Semantics match the
    # scalar loop (and the C++ kernel): among still-available gts, prefer a
    # non-ignored gt with IoU >= thr; only if none qualifies, an ignored
    # one; ties on IoU pick the highest gt index (the scalar loop's `<`
    # comparison lets later equal values replace earlier ones).
    t_n, d_n, g_n = len(thrs), ious.shape[0], ious.shape[1]
    dtm = np.zeros((t_n, d_n), np.int64)
    dt_ig = np.zeros((t_n, d_n), np.uint8)
    gt_ignore = gt_ignore.astype(bool)
    crowd = iscrowd.astype(bool)
    thr_eps = np.minimum(thrs, 1 - 1e-10)

    def last_argmax(row):
        return g_n - 1 - int(np.argmax(row[::-1]))

    for ti in range(t_n):
        gt_taken = np.zeros(g_n, bool)
        for di in range(d_n):
            avail = ~gt_taken | crowd
            row = np.where(avail, ious[di], -1.0)
            m = -1
            cand = np.where(~gt_ignore, row, -1.0)
            if g_n and cand.max() >= thr_eps[ti]:
                m = last_argmax(cand)
            else:
                cand = np.where(gt_ignore, row, -1.0)
                if g_n and cand.max() >= thr_eps[ti]:
                    m = last_argmax(cand)
            if m > -1:
                dtm[ti, di] = m + 1
                gt_taken[m] = True
                dt_ig[ti, di] = gt_ignore[m]
    return dtm, dt_ig


class COCODetEval:
    """Evaluate a flat list of detections against COCOGt annotations.

    detections: [{image_id, category_id, bbox [x,y,w,h], score}] — the format
    of the reference's in-memory `onlineRes` path (datasets/coco.py:318-321).
    """

    def __init__(self, coco_gt, detections: List[dict],
                 img_ids: Optional[Sequence] = None,
                 cat_ids: Optional[Sequence] = None):
        self.iouThrs = np.linspace(0.5, 0.95, 10)
        self.recThrs = np.linspace(0.0, 1.00, 101)
        self.maxDets = [1, 10, 100]
        self.areaRng = [[0.0, 1e10], [0.0, 32 ** 2],
                        [32 ** 2, 96 ** 2], [96 ** 2, 1e10]]
        self.areaRngLbl = ["all", "small", "medium", "large"]

        self.img_ids = list(img_ids if img_ids is not None
                            else sorted(coco_gt.images))
        self.cat_ids = list(cat_ids if cat_ids is not None else
                            coco_gt.cat_ids)

        self._gts = defaultdict(list)
        img_set = set(self.img_ids)
        for ann in coco_gt.annotations:
            if ann["image_id"] in img_set:
                self._gts[(ann["image_id"], ann["category_id"])].append(ann)
        self._dts = defaultdict(list)
        for d in detections:
            if d["image_id"] in img_set:
                self._dts[(d["image_id"], d["category_id"])].append(d)
        self.eval = {}
        self.stats = None

    # ------------------------------------------------------------------
    def _prepare_img(self, img_id, cat_id, max_det):
        """Per-(img, cat) work shared by all 4 area ranges: score-sort +
        cap the detections, extract gt arrays, compute the IoU matrix once
        (pycocotools' computeIoU/evaluateImg split — cocoeval.py caches
        `self.ious[imgId, catId]` and every area range reuses it)."""
        gts = self._gts[(img_id, cat_id)]
        dts = self._dts[(img_id, cat_id)]
        if not gts and not dts:
            return None
        # dt sorted by score desc (stable), capped
        d_scores = np.array([d["score"] for d in dts])
        d_order = np.argsort(-d_scores, kind="mergesort")[:max_det]
        dts = [dts[i] for i in d_order]

        g_box = np.array([g["bbox"] for g in gts], np.float64).reshape(-1, 4)
        d_box = np.array([d["bbox"] for d in dts], np.float64).reshape(-1, 4)
        crowd = np.array([int(g.get("iscrowd", 0)) for g in gts], np.uint8)
        base_ig = np.array([
            bool(g.get("ignore", 0)) or bool(g.get("iscrowd", 0))
            for g in gts], dtype=bool)
        g_area = np.array([g["area"] for g in gts], np.float64)
        return {
            "ious": bbox_iou_xywh(d_box, g_box, crowd),
            "crowd": crowd,
            "base_ig": base_ig,
            "g_area": g_area,
            "d_area": d_box[:, 2] * d_box[:, 3],
            "d_scores": np.array([d["score"] for d in dts]),
        }

    def _evaluate_img(self, prep, a_rng):
        """Matching for one area range, reusing the prepared IoU matrix."""
        g_ig = (prep["base_ig"] | (prep["g_area"] < a_rng[0]) |
                (prep["g_area"] > a_rng[1]))
        # gt sorted ignore-last (stable); index the cached IoU columns
        g_order = np.argsort(g_ig, kind="mergesort")
        g_ig = g_ig[g_order]
        crowd = prep["crowd"][g_order]
        ious = prep["ious"][:, g_order] if prep["ious"].size else prep["ious"]

        dtm, dt_ig = greedy_match(np.ascontiguousarray(ious),
                                  g_ig.astype(np.uint8), crowd,
                                  self.iouThrs)
        # unmatched dts outside the area range are ignored too
        d_out = (prep["d_area"] < a_rng[0]) | (prep["d_area"] > a_rng[1])
        dt_ig = np.logical_or(dt_ig.astype(bool),
                              (dtm == 0) & d_out[None, :])
        return {
            "dtMatches": dtm,
            "dtIgnore": dt_ig,
            "gtIgnore": g_ig,
            "dtScores": prep["d_scores"],
            "num_gt": int(np.count_nonzero(~g_ig)),
        }

    # ------------------------------------------------------------------
    def evaluate(self):
        self._img_results = {}
        max_det = self.maxDets[-1]
        for ci, cat_id in enumerate(self.cat_ids):
            for img_id in self.img_ids:
                prep = self._prepare_img(img_id, cat_id, max_det)
                if prep is None:
                    continue
                for ai, a_rng in enumerate(self.areaRng):
                    self._img_results[(ci, ai, img_id)] = \
                        self._evaluate_img(prep, a_rng)

    def accumulate(self):
        t_n = len(self.iouThrs)
        r_n = len(self.recThrs)
        k_n = len(self.cat_ids)
        a_n = len(self.areaRng)
        m_n = len(self.maxDets)
        precision = -np.ones((t_n, r_n, k_n, a_n, m_n))
        recall = -np.ones((t_n, k_n, a_n, m_n))
        scores = -np.ones((t_n, r_n, k_n, a_n, m_n))

        for ci in range(k_n):
            for ai in range(a_n):
                results = [self._img_results.get((ci, ai, img_id))
                           for img_id in self.img_ids]
                results = [r for r in results if r is not None]
                if not results:
                    continue
                npig = sum(r["num_gt"] for r in results)
                if npig == 0:
                    continue
                for mi, max_det in enumerate(self.maxDets):
                    dt_scores = np.concatenate(
                        [r["dtScores"][:max_det] for r in results])
                    order = np.argsort(-dt_scores, kind="mergesort")
                    sorted_scores = dt_scores[order]
                    dtm = np.concatenate(
                        [r["dtMatches"][:, :max_det] for r in results],
                        axis=1)[:, order]
                    dt_ig = np.concatenate(
                        [r["dtIgnore"][:, :max_det] for r in results],
                        axis=1)[:, order]
                    tps = (dtm > 0) & ~dt_ig
                    fps = (dtm == 0) & ~dt_ig
                    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                    for ti in range(t_n):
                        tp = tp_sum[ti]
                        fp = fp_sum[ti]
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / np.maximum(fp + tp,
                                             np.spacing(1))
                        recall[ti, ci, ai, mi] = rc[-1] if nd else 0.0
                        q = np.zeros(r_n)
                        ss = np.zeros(r_n)
                        pr = pr.tolist()
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, self.recThrs, side="left")
                        for ri, pi in enumerate(inds):
                            if pi < nd:
                                q[ri] = pr[pi]
                                ss[ri] = sorted_scores[pi]
                        precision[ti, :, ci, ai, mi] = q
                        scores[ti, :, ci, ai, mi] = ss
        self.eval = {"precision": precision, "recall": recall,
                     "scores": scores}

    # ------------------------------------------------------------------
    def _summary_value(self, ap: int, iou_thr=None, area="all",
                       max_dets=100, class_index=None) -> float:
        aind = self.areaRngLbl.index(area)
        mind = self.maxDets.index(max_dets)
        if ap:
            s = self.eval["precision"]
            if iou_thr is not None:
                s = s[np.where(self.iouThrs == iou_thr)[0]]
            s = (s[:, :, class_index, aind, mind] if class_index is not None
                 else s[:, :, :, aind, mind])
        else:
            s = self.eval["recall"]
            if iou_thr is not None:
                s = s[np.where(self.iouThrs == iou_thr)[0]]
            s = (s[:, class_index, aind, mind] if class_index is not None
                 else s[:, :, aind, mind])
        vals = s[s > -1]
        return float(np.mean(vals)) if len(vals) else -1.0

    def summarize(self, class_index=None, verbose: bool = True) -> np.ndarray:
        """The 12 standard stats, optionally restricted to `class_index`
        (0-based positions into cat_ids) — customCOCOeval (coco.py:461-545)."""
        if not self.eval:
            raise RuntimeError("run evaluate() + accumulate() first")
        specs = [
            (1, None, "all", 100), (1, 0.5, "all", 100),
            (1, 0.75, "all", 100), (1, None, "small", 100),
            (1, None, "medium", 100), (1, None, "large", 100),
            (0, None, "all", 1), (0, None, "all", 10), (0, None, "all", 100),
            (0, None, "small", 100), (0, None, "medium", 100),
            (0, None, "large", 100),
        ]
        stats = np.array([
            self._summary_value(ap, thr, area, md, class_index)
            for ap, thr, area, md in specs])
        if verbose:
            names = ["AP", "AP50", "AP75", "APs", "APm", "APl",
                     "AR1", "AR10", "AR100", "ARs", "ARm", "ARl"]
            for n, v in zip(names, stats):
                print(f"  {n:>6}: {v:.3f}")
        self.stats = stats
        return stats


def dets_to_coco_results(all_boxes: Dict[int, Dict[int, np.ndarray]],
                         record_index_to_img_id: Dict[int, int],
                         class_ind_to_cat_id: Dict[int, int]) -> List[dict]:
    """all_boxes[class_ind][record_index] = [N,5] x1y1x2y2+score (0-based)
    -> COCO result dicts with the reference's +1 width convention
    (coco.py:339-357: w = x2 - x1 + 1)."""
    results = []
    for ci, per_img in all_boxes.items():
        cat_id = class_ind_to_cat_id[ci]
        for rec_idx, dets in per_img.items():
            img_id = record_index_to_img_id[rec_idx]
            for d in np.asarray(dets).reshape(-1, 5):
                results.append({
                    "image_id": img_id,
                    "category_id": cat_id,
                    "bbox": [float(d[0]), float(d[1]),
                             float(d[2] - d[0] + 1), float(d[3] - d[1] + 1)],
                    "score": float(d[4]),
                })
    return results
