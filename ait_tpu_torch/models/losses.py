"""Loss functions of the train step (counterpart of ait_tpu/models/losses.py):
smooth-L1 with inside/outside weights, masked cross-entropy and the pairwise
margin-ranking loss, all in float32.
"""

from __future__ import annotations

import torch


def smooth_l1_loss(pred, target, inside_weights, outside_weights,
                   sigma: float = 1.0, reduce_dims=(1,)):
    """Weighted smooth-L1 (net_utils.py:75-90): sum over reduce_dims, mean
    over the rest."""
    sigma2 = sigma ** 2
    diff = inside_weights * (pred - target)
    abs_diff = diff.abs()
    sign = (abs_diff < 1.0 / sigma2).to(pred.dtype)
    per = (diff ** 2) * (sigma2 / 2.0) * sign + \
        (abs_diff - 0.5 / sigma2) * (1.0 - sign)
    per = outside_weights * per
    return per.sum(dim=tuple(reduce_dims)).mean()


def masked_cross_entropy(logits, labels, valid):
    """Mean softmax cross-entropy over the `valid` entries; labels < 0 count
    as class 0 (they are masked out anyway)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ce = -torch.gather(logp, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    valid = valid.float()
    return (ce * valid).sum() / valid.sum().clamp(min=1.0)


def margin_ranking_loss(score_prob, labels, margin: float):
    """Pairwise ranking of |p_i - p_j| against |l_i - l_j| per image
    (torch.nn.MarginRankingLoss with target 2 * gt_map - 1)."""
    lab = labels.float()
    gt_map = (lab[:, None, :] - lab[:, :, None]).abs()
    p = score_prob.float()
    pr_map = (p[:, None, :] - p[:, :, None]).abs()
    target = 2.0 * gt_map - 1.0
    return torch.clamp(-target * (pr_map - gt_map) + margin, min=0.0).mean()
