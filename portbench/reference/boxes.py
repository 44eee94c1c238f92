"""Plain box arithmetic of the AIT detector: anchors, delta decode and
encode, clipping, IoU and greedy NMS.

Faster R-CNN's Caffe-era conventions (lib/model/rpn/bbox_transform.py and
generate_anchors.py of the AIT repository): widths and heights carry a +1,
clipping clamps to size - 1, and an NMS overlap test is IoU > threshold,
written inter > threshold * union so that no division rounds.  Ties in
score keep their index order (a stable sort), as lax.top_k orders them.
"""

from __future__ import annotations

import numpy as np
import torch


def base_anchors(ratios=(0.5, 1.0, 2.0), scales=(8, 16, 32),
                 base_size: int = 16) -> np.ndarray:
    """[A, 4] anchors around the (0, 0, 15, 15) window, ratios first."""
    def whctr(a):
        w, h = a[2] - a[0] + 1, a[3] - a[1] + 1
        return w, h, a[0] + 0.5 * (w - 1), a[1] + 0.5 * (h - 1)

    def make(ws, hs, cx, cy):
        ws, hs = ws[:, None], hs[:, None]
        return np.hstack([cx - 0.5 * (ws - 1), cy - 0.5 * (hs - 1),
                          cx + 0.5 * (ws - 1), cy + 0.5 * (hs - 1)])

    w, h, cx, cy = whctr(np.array([0, 0, base_size - 1, base_size - 1],
                                  np.float64))
    ws = np.round(np.sqrt(w * h / np.asarray(ratios, np.float64)))
    hs = np.round(ws * np.asarray(ratios, np.float64))
    out = []
    for a in make(ws, hs, cx, cy):
        w, h, cx, cy = whctr(a)
        sc = np.asarray(scales, np.float64)
        out.append(make(w * sc, h * sc, cx, cy))
    return np.vstack(out).astype(np.float32)


def all_anchors(feat_h: int, feat_w: int, stride: int, ratios,
                scales) -> np.ndarray:
    """[H*W*A, 4] float32, index (y * W + x) * A + a."""
    base = base_anchors(ratios, scales)
    sx = np.arange(feat_w, dtype=np.float32) * stride
    sy = np.arange(feat_h, dtype=np.float32) * stride
    gx, gy = np.meshgrid(sx, sy)
    shifts = np.stack([gx, gy, gx, gy], axis=-1).reshape(-1, 1, 4)
    return (shifts + base[None]).reshape(-1, 4)


def _whctr(b):
    w = b[..., 2] - b[..., 0] + 1.0
    h = b[..., 3] - b[..., 1] + 1.0
    return w, h, b[..., 0] + 0.5 * w, b[..., 1] + 0.5 * h


def decode(boxes, deltas):
    """Boxes [..., 4] moved by deltas [..., 4] (dx, dy, dw, dh)."""
    w, h, cx, cy = _whctr(boxes)
    pcx = deltas[..., 0] * w + cx
    pcy = deltas[..., 1] * h + cy
    pw = torch.exp(deltas[..., 2]) * w
    ph = torch.exp(deltas[..., 3]) * h
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph,
                        pcx + 0.5 * pw, pcy + 0.5 * ph], dim=-1)


def encode(ex, gt):
    """The deltas that move ex onto gt."""
    ew, eh, ex_, ey = _whctr(ex)
    gw, gh, gx, gy = _whctr(gt)
    return torch.stack([(gx - ex_) / ew, (gy - ey) / eh,
                        torch.log(gw / ew), torch.log(gh / eh)], dim=-1)


def clip(boxes, hw):
    """Clamp to [0, W - 1] x [0, H - 1]; hw [..., 2] = (height, width)."""
    h, w = hw[..., 0:1].to(boxes.dtype), hw[..., 1:2].to(boxes.dtype)
    x = torch.minimum(boxes[..., 0::2].clamp(min=0.0), w - 1.0)
    y = torch.minimum(boxes[..., 1::2].clamp(min=0.0), h - 1.0)
    return torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], dim=-1)


def iou(a, b):
    """Pairwise IoU with +1 areas: [..., N, 4] x [..., K, 4] -> [..., N, K]."""
    inter, union = _inter_union(a, b)
    return inter / union


def _inter_union(a, b):
    a, b = a[..., :, None, :], b[..., None, :, :]
    iw = (torch.minimum(a[..., 2], b[..., 2]) -
          torch.maximum(a[..., 0], b[..., 0]) + 1.0).clamp(min=0.0)
    ih = (torch.minimum(a[..., 3], b[..., 3]) -
          torch.maximum(a[..., 1], b[..., 1]) + 1.0).clamp(min=0.0)
    area_a = (a[..., 2] - a[..., 0] + 1.0) * (a[..., 3] - a[..., 1] + 1.0)
    area_b = (b[..., 2] - b[..., 0] + 1.0) * (b[..., 3] - b[..., 1] + 1.0)
    inter = iw * ih
    return inter, area_a + area_b - inter


def greedy_nms(boxes, valid, thresh: float, max_keep: int, block=1024):
    """Greedy NMS of one image's boxes [N, 4], already in score order:
    a box is kept if it is valid and no earlier kept box overlaps it by
    more than `thresh`.  Stops after `max_keep` survivors.  Returns the
    kept positions in order (int64 numpy array)."""
    n = boxes.shape[0]
    thr = torch.tensor(thresh, dtype=torch.float32, device=boxes.device)
    alive = valid.cpu().numpy().copy()
    kept = []
    for start in range(0, n, block):
        stop = min(n, start + block)
        # rows: this block's boxes; columns: every later box
        inter, union = _inter_union(boxes[start:stop], boxes[start:])
        over = (inter > thr * union).cpu().numpy()
        for i in range(start, stop):
            if not alive[i]:
                continue
            kept.append(i)
            if len(kept) == max_keep:
                return np.asarray(kept, np.int64)
            row = over[i - start]
            alive[i + 1:] &= ~row[i - start + 1:]
    return np.asarray(kept, np.int64)


def nms_topk(boxes, scores, valid, thresh: float, pre_topk: int,
             post_topk: int):
    """Per image: the pre_topk best valid boxes by score (ties in index
    order), greedy NMS, the first post_topk survivors.  boxes [B, N, 4],
    scores [B, N], valid [B, N] -> (boxes [B, post, 4], scores [B, post],
    kept [B, post] bool), rows past the survivors zero."""
    bsz = boxes.shape[0]
    out_b = boxes.new_zeros((bsz, post_topk, 4))
    out_s = scores.new_zeros((bsz, post_topk))
    out_v = torch.zeros((bsz, post_topk), dtype=torch.bool,
                        device=boxes.device)
    for i in range(bsz):
        s = torch.where(valid[i], scores[i], -torch.inf)
        order = torch.sort(s, descending=True, stable=True).indices
        order = order[:min(pre_topk, order.shape[0])]
        ok = valid[i][order]
        keep = greedy_nms(boxes[i][order], ok, thresh, post_topk)
        idx = order[torch.as_tensor(keep, device=boxes.device)]
        k = idx.shape[0]
        out_b[i, :k] = boxes[i][idx]
        out_s[i, :k] = scores[i][idx]
        out_v[i, :k] = True
    return out_b, out_s, out_v
