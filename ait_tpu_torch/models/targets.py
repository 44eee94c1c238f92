"""Training target assignment, batched and fixed-shape (counterpart of
ait_tpu/models/targets.py).

anchor_target_layer.py:50-199 and proposal_target_layer_cascade.py:123-220
of the reference, as the JAX package writes them:
  * "sample k of n without replacement" keeps the entries whose uniform key
    is at most the k-th smallest key;
  * a random permutation of the True entries is a stable sort of their
    uniform keys (every other entry keyed 2.0, so it sorts last);
  * "sample with replacement" is floor(uniform * n).

The uniforms are an argument: `AnchorDraws` / `ProposalDraws`, drawn from
the caller's `torch.Generator` by default.  Given the same uniforms as the
JAX package draws, the labels, rois and counts are equal and the regression
targets agree to float32 rounding.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ait_tpu_torch.ops.boxes import bbox_overlaps_masked, bbox_transform


class AnchorTargets(NamedTuple):
    labels: torch.Tensor           # [B, N] int32 in {-1, 0, 1}
    bbox_targets: torch.Tensor     # [B, N, 4]
    inside_weights: torch.Tensor   # [B, N, 4]
    outside_weights: torch.Tensor  # [B, N, 4]


class ProposalTargets(NamedTuple):
    rois: torch.Tensor             # [B, R, 5] (batch index in col 0)
    labels: torch.Tensor           # [B, R] int32 (binary match label)
    bbox_targets: torch.Tensor     # [B, R, 4] (normalized)
    inside_weights: torch.Tensor   # [B, R, 4]
    outside_weights: torch.Tensor  # [B, R, 4]


class AnchorDraws(NamedTuple):
    """Per-image uniforms in [0, 1): keys of the fg and bg subsampling."""
    fg: torch.Tensor               # [B, N]
    bg: torch.Tensor               # [B, N]


class ProposalDraws(NamedTuple):
    fg_order: torch.Tensor         # [B, Np] keys of the fg permutation
    bg_order: torch.Tensor         # [B, Np] keys of the bg permutation
    fg_pick: torch.Tensor          # [B, R] with-replacement fg draws
    bg_pick: torch.Tensor          # [B, R] with-replacement bg draws


def _uniform(shape, generator: Optional[torch.Generator], device):
    gdev = generator.device if generator is not None else torch.device("cpu")
    return torch.rand(shape, generator=generator, device=gdev).to(device)


def _keep_k_random(mask, k, r, k_max: int):
    """Keep at most k True entries of each row of `mask` [B, n]: those whose
    key r is at most the k-th smallest key among the True entries."""
    n = mask.shape[-1]
    masked = torch.where(mask, r, 2.0)
    smallest = torch.sort(masked, dim=-1, stable=True).values[..., :min(k_max, n)]
    idx = (k - 1).clamp(0, smallest.shape[-1] - 1)
    kth = torch.gather(smallest, -1, idx[..., None])[..., 0]
    kth = torch.where(k > 0, kth, -1.0)
    return mask & (masked <= kth[..., None])


def anchor_targets(anchors, gt_boxes, im_info, *, batch_size: int = 256,
                   fg_fraction: float = 0.5, positive_overlap: float = 0.7,
                   negative_overlap: float = 0.3,
                   clobber_positives: bool = False,
                   draws: Optional[AnchorDraws] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> AnchorTargets:
    """RPN labels for every anchor.  anchors [N, 4]; gt_boxes [B, G, 5]
    zero-padded; im_info [B, 3].  Inside-image anchors only; bg if max IoU <
    negative_overlap; fg if the anchor ties a gt's max IoU or its max IoU >=
    positive_overlap; then a random subsample to batch_size at fg_fraction."""
    b, n = gt_boxes.shape[0], anchors.shape[0]
    dev = anchors.device
    if draws is None:
        draws = AnchorDraws(_uniform((b, n), generator, dev),
                            _uniform((b, n), generator, dev))
    num_fg = int(fg_fraction * batch_size)
    gt = gt_boxes[..., :4].float()
    info = im_info.float()
    inside = ((anchors[None, :, 0] >= 0) & (anchors[None, :, 1] >= 0) &
              (anchors[None, :, 2] < info[:, None, 1]) &
              (anchors[None, :, 3] < info[:, None, 0]))            # [B, N]
    overlaps = bbox_overlaps_masked(anchors[None], gt)             # [B, N, G]
    overlaps = torch.where(inside[..., None], overlaps, -1.0)
    max_ov, argmax_gt = overlaps.max(dim=2)

    labels = torch.full((b, n), -1, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    one = torch.ones((), dtype=torch.int32, device=dev)
    if not clobber_positives:
        labels = torch.where(inside & (max_ov < negative_overlap), zero,
                             labels)
    gt_max = overlaps.max(dim=1).values                            # [B, G]
    gt_max = torch.where(gt_max == 0, 1e-5, gt_max)
    is_gt_argmax = (overlaps == gt_max[:, None, :]).any(dim=2)
    labels = torch.where(inside & is_gt_argmax, one, labels)
    labels = torch.where(inside & (max_ov >= positive_overlap), one, labels)
    if clobber_positives:
        labels = torch.where(inside & (max_ov < negative_overlap), zero,
                             labels)

    fg_cap = torch.full((b,), num_fg, dtype=torch.int64, device=dev)
    keep_fg = _keep_k_random(labels == 1, fg_cap, draws.fg, num_fg)
    labels = torch.where((labels == 1) & ~keep_fg, -one, labels)
    num_bg = batch_size - (labels == 1).sum(dim=1)
    keep_bg = _keep_k_random(labels == 0, num_bg, draws.bg, batch_size)
    labels = torch.where((labels == 0) & ~keep_bg, -one, labels)

    # an index gather of the matched gt box (the JAX package's HIGHEST-
    # precision one-hot product computes exactly the same values)
    matched = torch.gather(gt, 1, argmax_gt[..., None].expand(-1, -1, 4))
    targets = bbox_transform(anchors[None].expand(b, -1, -1), matched)
    ones4 = torch.ones(4, device=dev)
    inside_w = (labels == 1).float()[..., None] * ones4
    num_examples = (labels >= 0).sum(dim=1).clamp(min=1)
    outside_w = torch.where(labels >= 0, 1.0 / num_examples[:, None],
                            0.0)[..., None] * ones4
    return AnchorTargets(labels, targets, inside_w, outside_w)


def proposal_targets(rois, gt_boxes, *, rois_per_image: int = 128,
                     fg_fraction: float = 0.25, fg_thresh: float = 0.5,
                     bg_thresh_hi: float = 0.5, bg_thresh_lo: float = 0.1,
                     bbox_normalize_means=(0.0, 0.0, 0.0, 0.0),
                     bbox_normalize_stds=(0.1, 0.1, 0.2, 0.2),
                     bbox_inside_weights=(1.0, 1.0, 1.0, 1.0),
                     draws: Optional[ProposalDraws] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> ProposalTargets:
    """Sample rois_per_image training rois per image from the proposals plus
    the gt boxes: fg without replacement, bg with replacement, and the
    reference's fg-only / bg-only cases.  rois [B, P, 5]; gt_boxes [B, G, 5]
    zero-padded."""
    b, g = gt_boxes.shape[0], gt_boxes.shape[1]
    dev = rois.device
    r = rois_per_image
    fg_per_image = max(int(round(fg_fraction * r)), 1)
    gt = gt_boxes.float()
    gt_append = torch.cat([torch.zeros((b, g, 1), device=dev), gt[..., :4]],
                          dim=2)
    all_rois = torch.cat([rois.float(), gt_append], dim=1)        # [B, Np, 5]
    n_p = all_rois.shape[1]
    if draws is None:
        draws = ProposalDraws(_uniform((b, n_p), generator, dev),
                              _uniform((b, n_p), generator, dev),
                              _uniform((b, r), generator, dev),
                              _uniform((b, r), generator, dev))

    overlaps = bbox_overlaps_masked(all_rois[..., 1:5], gt[..., :4])
    max_ov, gt_assignment = overlaps.max(dim=2)                    # [B, Np]
    labels_raw = torch.gather(gt[..., 4], 1, gt_assignment).to(torch.int32)

    fg_mask = max_ov >= fg_thresh
    bg_mask = (max_ov < bg_thresh_hi) & (max_ov >= bg_thresh_lo)
    fg_num = fg_mask.sum(dim=1)
    bg_num = bg_mask.sum(dim=1)
    has_fg = fg_num > 0
    has_bg = bg_num > 0

    compact_fg = torch.sort(torch.where(fg_mask, draws.fg_order, 2.0), dim=1,
                            stable=True).indices
    compact_bg = torch.sort(torch.where(bg_mask, draws.bg_order, 2.0), dim=1,
                            stable=True).indices
    fg_draw = torch.floor(draws.fg_pick *
                          fg_num.clamp(min=1)[:, None].float()).long()
    bg_draw = torch.floor(draws.bg_pick *
                          bg_num.clamp(min=1)[:, None].float()).long()

    fg_this = torch.where(has_fg & has_bg,
                          torch.clamp(fg_num, max=fg_per_image),
                          torch.where(has_fg, r, 0))[:, None]
    i = torch.arange(r, device=dev)[None, :].expand(b, r)
    fg_pick = torch.where(has_bg[:, None],
                          torch.gather(compact_fg, 1, i.clamp(max=n_p - 1)),
                          torch.gather(compact_fg, 1, fg_draw))
    bg_pick = torch.gather(compact_bg, 1, bg_draw)
    picks = torch.where(i < fg_this, fg_pick, bg_pick)            # [B, R]

    labels = torch.where(i < fg_this, torch.gather(labels_raw, 1, picks),
                         torch.zeros((), dtype=torch.int32, device=dev))
    rois_out = torch.gather(all_rois, 1, picks[..., None].expand(-1, -1, 5))
    img_idx = torch.arange(b, dtype=rois_out.dtype, device=dev)
    rois_out = torch.cat([img_idx[:, None, None].expand(b, r, 1),
                          rois_out[..., 1:]], dim=2)

    gt_sel = torch.gather(gt[..., :4], 1,
                          torch.gather(gt_assignment, 1, picks)[..., None]
                          .expand(-1, -1, 4))
    means = torch.tensor(bbox_normalize_means, device=dev)
    stds = torch.tensor(bbox_normalize_stds, device=dev)
    in_w = torch.tensor(bbox_inside_weights, device=dev)
    targets = (bbox_transform(rois_out[..., 1:5], gt_sel) - means) / stds
    inside_w = torch.where(labels[..., None] > 0, in_w, 0.0)
    outside_w = (inside_w > 0).to(targets.dtype)
    return ProposalTargets(rois_out, labels, targets, inside_w, outside_w)
