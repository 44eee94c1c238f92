"""Exact greedy NMS over score-sorted boxes (counterpart of ait_tpu/ops/nms.py
and ait_tpu/ops/nms_pallas.py).

`nms_keep_mask` is the plain version: the JAX package's tile sweep, line by
line.  Boxes are processed in tiles of `tile`; each tile is first suppressed
by the survivors of earlier tiles (a compacted buffer capped at `max_out`),
then resolved inside by iterative peeling, whose fixpoint is the sequential
greedy answer.  The sweep stops once `max_out` survivors exist, so only the
keep bits of the first `max_out` survivors are exact; callers take those.

`nms_keep_mask_batched` is the wrapper of the CUDA kernel
(csrc/nms.cu, which replaces ait_tpu/ops/nms_pallas.py:133
nms_keep_mask_batched; a cluster of 16 blocks per image shares each
tile's IoU tests): a CUDA tensor goes to the kernel, a CPU tensor to
the plain version.  The IoU test is division-free (inter > thr * union,
+1 areas) so that every version rounds the same way.
"""

from __future__ import annotations

import ctypes

import torch

from ait_tpu_torch.ops import _build

NEG_INF = -1e30


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _iou_exceeds(a, b, thresh):
    """(IoU > thresh) as inter > thresh * union.  a: [N, 4], b: [M, 4] ->
    [N, M] bool."""
    iw = (torch.minimum(a[:, None, 2], b[None, :, 2]) -
          torch.maximum(a[:, None, 0], b[None, :, 0]) + 1.0)
    ih = (torch.minimum(a[:, None, 3], b[None, :, 3]) -
          torch.maximum(a[:, None, 1], b[None, :, 1]) + 1.0)
    inter = iw.clamp(min=0.0) * ih.clamp(min=0.0)
    area_a = (a[:, 2] - a[:, 0] + 1.0) * (a[:, 3] - a[:, 1] + 1.0)
    area_b = (b[:, 2] - b[:, 0] + 1.0) * (b[:, 3] - b[:, 1] + 1.0)
    union = area_a[:, None] + area_b[None, :] - inter
    thr = torch.tensor(thresh, dtype=torch.float32, device=a.device)
    return inter > thr * union


def _tile_self_suppress(adj, alive):
    """Greedy inside one tile: adj[k, j] <=> k < j and IoU(k, j) > thr."""
    while True:
        incoming = (adj & alive[:, None]).any(dim=0)
        dominators = alive & ~incoming
        victims = alive & (adj & dominators[:, None]).any(dim=0)
        alive = alive & ~victims
        if not bool(victims.any()):
            return alive


def nms_keep_mask(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold,
                  tile: int = 256, max_out: int | None = None
                  ) -> torch.Tensor:
    """Keep-mask of one image.  boxes [N, 4] float32 in descending score
    order; valid [N] bool.  Returns [N] bool."""
    n = boxes.shape[0]
    n_pad = _round_up(n, tile)
    dev = boxes.device
    boxes_p = torch.zeros((n_pad, 4), dtype=boxes.dtype, device=dev)
    boxes_p[:n] = boxes
    keep = torch.zeros((n_pad,), dtype=torch.bool, device=dev)
    keep[:n] = valid

    cap = n if max_out is None else min(max_out, n)
    cap_pad = _round_up(cap, 128)
    surv = torch.zeros((cap_pad, 4), dtype=boxes.dtype, device=dev)
    r = torch.arange(tile, device=dev)
    later = r[:, None] < r[None, :]
    scount = 0
    for start in range(0, n_pad, tile):
        if scount >= cap:
            break
        tb = boxes_p[start:start + tile]
        tk = keep[start:start + tile]
        if scount:
            prev = _iou_exceeds(tb, surv[:min(scount, cap_pad)],
                                iou_threshold)
            tk = tk & ~prev.any(dim=1)
        adj = _iou_exceeds(tb, tb, iou_threshold) & later
        tk = _tile_self_suppress(adj, tk)
        kept = tb[tk][:max(cap_pad - scount, 0)]
        surv[scount:scount + kept.shape[0]] = kept
        keep[start:start + tile] = tk
        scount += int(tk.sum())
    return keep[:n]


def nms_keep_mask_reference(boxes: torch.Tensor, valid: torch.Tensor,
                            iou_threshold, tile: int = 256,
                            max_out: int | None = None) -> torch.Tensor:
    """Plain batched version: [B, N, 4], [B, N] -> [B, N] bool."""
    return torch.stack([nms_keep_mask(boxes[i], valid[i], iou_threshold,
                                      tile, max_out)
                        for i in range(boxes.shape[0])])


_FUNCS = {"nms_keep_mask": [ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                            ctypes.c_float, ctypes.c_int, ctypes.c_int,
                            ctypes.c_void_p]}


def nms_keep_mask_batched(boxes: torch.Tensor, valid: torch.Tensor,
                          iou_threshold: float, tile: int = 256,
                          max_out: int | None = None) -> torch.Tensor:
    """Batched keep-mask: boxes [B, N, 4] float32 in descending score order,
    valid [B, N] bool -> keep [B, N] bool.  The kernel writes zeros for the
    tiles after an image's survivor cap; the plain version leaves their
    valid bits.  Both agree on the first `max_out` survivors."""
    if boxes.device.type == "cpu":
        return nms_keep_mask_reference(boxes, valid, iou_threshold, tile,
                                       max_out)
    req = _build.require
    req(boxes.is_cuda, "nms: the kernel runs on CUDA tensors")
    req(boxes.dtype == torch.float32 and boxes.dim() == 3 and
        boxes.shape[2] == 4, "nms: boxes must be float32 [B, N, 4]")
    req(valid.dtype == torch.bool and valid.shape == boxes.shape[:2],
        "nms: valid must be bool [B, N]")
    _build.require_operands("nms", boxes.device, (boxes, valid))
    req(tile == 256, "nms: the kernel sweeps 256-box tiles")
    cap = boxes.shape[1] if max_out is None else min(max_out, boxes.shape[1])
    return _launch(boxes, valid, iou_threshold, cap)


def _launch(boxes, valid, iou_threshold, cap):
    """csrc/nms.cu on the operands `nms_keep_mask_batched` checked; counts
    one launch.  Each of an image's 16 blocks holds 1/16 of the survivors
    (16 bytes each) in shared memory."""
    b, n, _ = boxes.shape
    cap_pad = _round_up(cap, 128)
    _build.require(-(-cap_pad // 16) * 16 <= 160 * 1024,
                   f"nms: survivor cap {cap} exceeds the kernel's shared "
                   "memory")
    keep = torch.empty((b, n), dtype=torch.uint8, device=boxes.device)
    if b and n:
        lib = _build.load("nms", _FUNCS)
        _build.check(lib.nms_keep_mask(
            boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), b, n,
            float(iou_threshold), cap, cap_pad,
            _build.stream_ptr(boxes.device)), "nms_keep_mask")
        nms_keep_mask_batched.launches += 1
    return keep.bool()


nms_keep_mask_batched.launches = 0


def _select_top(keep: torch.Tensor, k: int):
    """Per row, the indices of the first k True positions (score order)
    and their count.  keep [B, N] -> (sel [B, min(k, N)], count [B])."""
    n = keep.shape[1]
    idx = torch.arange(n, device=keep.device)
    rank = torch.where(keep, idx, n)
    sel = torch.sort(rank, dim=1, stable=True).indices[:, :min(k, n)]
    count = keep.sum(dim=1).clamp(max=k)
    return sel, count


def batched_nms_topk(boxes: torch.Tensor, scores: torch.Tensor,
                     iou_threshold, pre_topk: int, post_topk: int,
                     tile: int = 256, valid=None):
    """Per image: top-k by score -> greedy NMS -> top-k of the kept.

    boxes [B, N, 4], scores [B, N]; valid: optional [B, N] bool (False rows
    can never be kept).  Returns (boxes [B, post, 4], scores [B, post],
    valid [B, post]); rows past the survivors are zero.

    lax.top_k orders equal scores by index; a stable descending sort does
    the same (torch.topk's order of ties on CUDA is unspecified).
    """
    bsz, n = scores.shape
    k = min(pre_topk, n)
    # the candidate count is rounded up to the sweep tile; rows past k are
    # taken but marked invalid (exactly an exact-k truncation)
    k_eff = min(n, _round_up(k, tile))
    dev = scores.device
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=dev)
    neg = torch.tensor(NEG_INF, dtype=scores.dtype, device=dev)
    scores = torch.where(valid, scores, neg)
    top_sc, order = torch.sort(scores, dim=1, descending=True, stable=True)
    top_sc, order = top_sc[:, :k_eff], order[:, :k_eff]
    sb = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    sva = top_sc > neg / 2
    if k_eff > k:
        sva = sva & (torch.arange(k_eff, device=dev) < k)[None, :]
    keep = nms_keep_mask_batched(sb.contiguous(), sva.contiguous(),
                                 iou_threshold, tile=tile, max_out=post_topk)
    sel, count = _select_top(keep, post_topk)
    p = sel.shape[1]
    out_valid = torch.arange(post_topk, device=dev)[None, :] < count[:, None]
    out_b = torch.zeros((bsz, post_topk, 4), dtype=boxes.dtype, device=dev)
    out_s = torch.zeros((bsz, post_topk), dtype=scores.dtype, device=dev)
    out_b[:, :p] = torch.gather(sb, 1, sel[..., None].expand(-1, -1, 4))
    out_s[:, :p] = torch.gather(top_sc, 1, sel)
    out_b = torch.where(out_valid[..., None], out_b, 0.0)
    out_s = torch.where(out_valid, out_s, 0.0)
    return out_b, out_s, out_valid
