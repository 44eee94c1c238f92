"""PASCAL VOC AP evaluation, VOC07 11-point and continuous (counterpart of
ait_tpu/evaluation/voc_eval.py).

Pinned to lib/datasets/voc_eval.py:35-211 with one deliberate difference: the
reference round-trips detections through result FILES in 1-based coordinates
(+1 on write, pascal_voc.py:328) and evaluates against the RAW XML boxes
(parse_rec keeps xmax/ymax untouched, voc_eval.py:26-29), while the training
roidb stores x2 = xmax - 1.  IoU is translation-invariant, so evaluating
0-based detections directly against `record.boxes + [-1, -1, 0, 0]` (i.e.
xmin-1, ymin-1, xmax-1, ymax-1) is numerically identical to the reference's
file round trip — no result files needed.

Matching rules preserved exactly: detections sorted by confidence globally,
IoU strictly > threshold, difficult gt neither TP nor FP, one det per gt,
npos counts non-difficult gt only.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from ait_tpu_torch.data.records import ImageRecord


def voc_ap(rec: np.ndarray, prec: np.ndarray,
           use_07_metric: bool = False) -> float:
    """AP from a PR curve (voc_eval.py:35-66)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.sum(rec >= t) > 0 else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1]))


def _iou_one_to_many(bb: np.ndarray, gts: np.ndarray) -> np.ndarray:
    ixmin = np.maximum(gts[:, 0], bb[0])
    iymin = np.maximum(gts[:, 1], bb[1])
    ixmax = np.minimum(gts[:, 2], bb[2])
    iymax = np.minimum(gts[:, 3], bb[3])
    iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
    ih = np.maximum(iymax - iymin + 1.0, 0.0)
    inter = iw * ih
    union = ((bb[2] - bb[0] + 1.0) * (bb[3] - bb[1] + 1.0) +
             (gts[:, 2] - gts[:, 0] + 1.0) * (gts[:, 3] - gts[:, 1] + 1.0) -
             inter)
    return inter / union


def eval_class(detections: Dict[int, np.ndarray],
               gt_boxes: Dict[int, np.ndarray],
               gt_difficult: Dict[int, np.ndarray],
               ovthresh: float = 0.5, use_07_metric: bool = True
               ) -> Tuple[np.ndarray, np.ndarray, float]:
    """One class.  detections: img_key -> [N, 5] (x1,y1,x2,y2,score);
    gt_boxes/gt_difficult: img_key -> [M, 4] / [M] over ALL images."""
    npos = 0
    matched = {}
    for key, diff in gt_difficult.items():
        npos += int(np.sum(~diff.astype(bool)))
        matched[key] = np.zeros(len(diff), bool)

    rows = []
    for key, dets in detections.items():
        for d in np.asarray(dets).reshape(-1, 5):
            rows.append((key, d))
    if not rows:
        return np.zeros(0), np.zeros(0), 0.0

    conf = np.array([d[4] for _, d in rows])
    order = np.argsort(-conf)
    tp = np.zeros(len(rows))
    fp = np.zeros(len(rows))
    for rank, oi in enumerate(order):
        key, det = rows[oi]
        gts = gt_boxes.get(key, np.zeros((0, 4)))
        if len(gts):
            overlaps = _iou_one_to_many(det[:4], gts)
            jmax = int(np.argmax(overlaps))
            ovmax = overlaps[jmax]
        else:
            ovmax, jmax = -np.inf, -1
        if ovmax > ovthresh:
            if not gt_difficult[key][jmax]:
                if not matched[key][jmax]:
                    tp[rank] = 1.0
                    matched[key][jmax] = True
                else:
                    fp[rank] = 1.0
        else:
            fp[rank] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(max(npos, 1))
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec, use_07_metric)


def _file_round_trip(dets: np.ndarray) -> np.ndarray:
    """Replicate the reference's result-FILE round trip on a det array.

    pascal_voc.py:328 writes each line as
    `{:.3f}`-formatted score and `{:.1f}`-formatted 1-based coordinates,
    and voc_eval reads those strings back — so the reference's AP is
    computed on quantized values.  Near-tied scores collapse to exact ties
    under %.3f, and np.argsort then orders them by file position, which
    can shift the PR curve.  This helper applies the identical text
    quantization (Python's repr-based formatting, not np.round, so
    half-even decisions match bit for bit) in our 0-based frame:
    coord -> float('%.1f' % (coord + 1)) - 1 (the integer translation is
    exact in float64)."""
    dets = np.asarray(dets, np.float64).reshape(-1, 5)
    out = np.empty_like(dets)
    for i, (x1, y1, x2, y2, s) in enumerate(dets):
        out[i] = (float(f"{x1 + 1:.1f}") - 1.0, float(f"{y1 + 1:.1f}") - 1.0,
                  float(f"{x2 + 1:.1f}") - 1.0, float(f"{y2 + 1:.1f}") - 1.0,
                  float(f"{s:.3f}"))
    return out


def evaluate_voc(all_boxes: Dict[int, Dict[int, np.ndarray]],
                 records: Sequence[ImageRecord],
                 class_inds: Sequence[int],
                 class_names: Sequence[str],
                 use_07_metric: bool = True,
                 ovthresh: float = 0.5,
                 file_quantize: bool = False) -> Dict[str, float]:
    """all_boxes[class_ind][record_index] -> [N, 5] dets (0-based coords).

    Returns {class_name: AP} + {'mAP': mean}; mirrors
    pascal_voc.evaluate_detections + _do_python_eval (pascal_voc.py:331-443).

    file_quantize=True additionally reproduces the reference's result-file
    round trip (%.3f scores / %.1f coords, see _file_round_trip) for
    bit-exact cross-evaluator comparisons; the default full-precision path
    is the better metric and differs only by tie-ordering noise.
    """
    results = {}
    aps = []
    shift = np.array([-1.0, -1.0, 0.0, 0.0])
    for ci, cname in zip(class_inds, class_names):
        gt_b, gt_d = {}, {}
        for idx, rec in enumerate(records):
            mask = rec.gt_classes == ci
            gt_b[idx] = rec.boxes[mask].astype(np.float64) + shift
            gt_d[idx] = rec.difficult[mask].astype(bool)
        dets = all_boxes.get(ci, {})
        if file_quantize:
            dets = {k: _file_round_trip(v) for k, v in dets.items()}
        _, _, ap = eval_class(dets, gt_b, gt_d, ovthresh, use_07_metric)
        results[cname] = ap
        aps.append(ap)
    results["mAP"] = float(np.mean(aps)) if aps else 0.0
    return results
