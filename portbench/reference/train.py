"""AIT's training step in plain PyTorch, float32: targets, the five losses,
dropout, autograd's backward and SGD, following model.py's forward.

The step's randomness comes from one torch.Generator, drawn in the
program's documented order: the co-attention's two dropout seeds, the
anchor sampling's two uniform arrays, the proposal sampling's four, then
the transformer's dropout seeds in call order (input glue, each layer's
attentions and FFN).  A seed keys the Philox stream (philox.py) that gives
each site's keep-mask.  Sampling "k of n without replacement" keeps the
entries whose uniform key is at most the k-th smallest; a random order is a
stable sort of the keys; "with replacement" is floor(uniform * n) (AIT's
anchor_target_layer.py and proposal_target_layer_cascade.py as the JAX
package writes them).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from . import boxes as bx
from . import model as R
from . import philox
from .params import frozen


class Stream:
    """The step's draws, from a torch.Generator on its device."""

    def __init__(self, generator: torch.Generator, keep_prob: float):
        self.g, self.keep_prob = generator, keep_prob

    def seed(self):
        return torch.randint(-2 ** 31, 2 ** 31, (2,), dtype=torch.int32,
                             generator=self.g, device=self.g.device)

    def uniform(self, shape):
        return torch.rand(shape, generator=self.g, device=self.g.device)

    def attn(self, p, tq, tk, d, heads=8):
        """(attn_keep [P, H, Tq, Tk], out_keep [P, Tq, D], keep_prob)."""
        s = self.seed()
        ak = philox.keep_mask(s, philox.TAG_ATTN, heads, p, tq * tk,
                              self.keep_prob)
        ok = philox.keep_mask(s, philox.TAG_OUT, 1, p, tq * d,
                              self.keep_prob)
        return (ak.view(heads, p, tq, tk).transpose(0, 1),
                ok.view(p, tq, d), self.keep_prob)

    def rows(self, tag, n, t, d):
        """(keep [N, T, D], keep_prob) of a row-wise site over N * T rows."""
        s = self.seed()
        k = philox.keep_mask(s, tag, 1, n * t, d, self.keep_prob)
        return k.view(n, t, d), self.keep_prob

    def site(self, d, heads):
        """The transformer's `drop` callable."""
        def draw(kind, n, tq, tk=None):
            if kind == "attn":
                return self.attn(n, tq, tk, d, heads)
            return self.rows(philox.TAG_GLUE if kind == "glue"
                             else philox.TAG_FFN, n, tq, d)
        return draw


def _zero_box(b):
    return (((b[..., 2] - b[..., 0] + 1.0) == 1.0) &
            ((b[..., 3] - b[..., 1] + 1.0) == 1.0))


def _overlaps(boxes, gt):
    """IoU with AIT's sentinels: an all-zero gt box zeroes its column, an
    all-zero candidate box sets its row to -1."""
    o = bx.iou(boxes, gt)
    o = torch.where(_zero_box(gt)[..., None, :], 0.0, o)
    return torch.where(_zero_box(boxes)[..., :, None], -1.0, o)


def _keep_k(mask, k, keys, k_max):
    """Per row, the True entries of `mask` whose key is at most the k-th
    smallest key among them."""
    n = mask.shape[-1]
    masked = torch.where(mask, keys, 2.0)
    small = torch.sort(masked, dim=-1, stable=True).values[..., :min(k_max, n)]
    kth = torch.gather(small, -1, (k - 1).clamp(0, small.shape[-1] - 1)
                       [..., None])[..., 0]
    kth = torch.where(k > 0, kth, -1.0)
    return mask & (masked <= kth[..., None])


class AnchorTargets(NamedTuple):
    labels: torch.Tensor
    targets: torch.Tensor
    inside: torch.Tensor
    outside: torch.Tensor


def anchor_targets(cfg, anchors, gt_boxes, im_info, stream: Stream):
    t = cfg["TRAIN"]
    b, n = gt_boxes.shape[0], anchors.shape[0]
    fg_keys, bg_keys = stream.uniform((b, n)), stream.uniform((b, n))
    num_fg = int(t["RPN_FG_FRACTION"] * t["RPN_BATCHSIZE"])
    gt = gt_boxes[..., :4].float()
    info = im_info.float()
    inside = ((anchors[None, :, 0] >= 0) & (anchors[None, :, 1] >= 0) &
              (anchors[None, :, 2] < info[:, None, 1]) &
              (anchors[None, :, 3] < info[:, None, 0]))
    ov = torch.where(inside[..., None], _overlaps(anchors[None], gt), -1.0)
    max_ov, arg = ov.max(dim=2)
    labels = torch.full((b, n), -1, dtype=torch.int32, device=anchors.device)
    neg = inside & (max_ov < t["RPN_NEGATIVE_OVERLAP"])
    if not t["RPN_CLOBBER_POSITIVES"]:
        labels = torch.where(neg, 0, labels)
    gt_max = ov.max(dim=1).values
    gt_max = torch.where(gt_max == 0, 1e-5, gt_max)
    is_arg = (ov == gt_max[:, None, :]).any(dim=2)
    labels = torch.where(inside & is_arg, 1, labels)
    labels = torch.where(inside & (max_ov >= t["RPN_POSITIVE_OVERLAP"]), 1,
                         labels)
    if t["RPN_CLOBBER_POSITIVES"]:
        labels = torch.where(neg, 0, labels)
    cap = torch.full((b,), num_fg, dtype=torch.int64, device=anchors.device)
    keep_fg = _keep_k(labels == 1, cap, fg_keys, num_fg)
    labels = torch.where((labels == 1) & ~keep_fg, -1, labels)
    num_bg = t["RPN_BATCHSIZE"] - (labels == 1).sum(dim=1)
    keep_bg = _keep_k(labels == 0, num_bg, bg_keys, t["RPN_BATCHSIZE"])
    labels = torch.where((labels == 0) & ~keep_bg, -1, labels)
    matched = torch.gather(gt, 1, arg[..., None].expand(-1, -1, 4))
    targets = bx.encode(anchors[None].expand(b, -1, -1), matched)
    inside_w = (labels == 1).float()[..., None].expand(-1, -1, 4)
    count = (labels >= 0).sum(dim=1).clamp(min=1)
    outside_w = torch.where(labels >= 0, 1.0 / count[:, None], 0.0)
    return AnchorTargets(labels, targets, inside_w,
                         outside_w[..., None].expand(-1, -1, 4))


class ProposalTargets(NamedTuple):
    rois: torch.Tensor
    labels: torch.Tensor
    targets: torch.Tensor
    inside: torch.Tensor
    outside: torch.Tensor


def proposal_targets(cfg, rois, gt_boxes, stream: Stream):
    """BATCH_SIZE rois an image from the proposals and the gt boxes: fg
    without replacement up to FG_FRACTION, bg with replacement, and AIT's
    fg-only and bg-only cases."""
    t = cfg["TRAIN"]
    b, g = gt_boxes.shape[:2]
    dev = rois.device
    r = t["BATCH_SIZE"]
    fg_per = max(int(round(t["FG_FRACTION"] * r)), 1)
    gt = gt_boxes.float()
    all_rois = torch.cat([rois.float(), torch.cat(
        [torch.zeros((b, g, 1), device=dev), gt[..., :4]], dim=2)], dim=1)
    n_p = all_rois.shape[1]
    fg_order, bg_order = stream.uniform((b, n_p)), stream.uniform((b, n_p))
    fg_u, bg_u = stream.uniform((b, r)), stream.uniform((b, r))
    ov = _overlaps(all_rois[..., 1:5], gt[..., :4])
    max_ov, assign = ov.max(dim=2)
    cls = torch.gather(gt[..., 4], 1, assign).to(torch.int32)
    fg = max_ov >= t["FG_THRESH"]
    bg = (max_ov < t["BG_THRESH_HI"]) & (max_ov >= t["BG_THRESH_LO"])
    n_fg, n_bg = fg.sum(dim=1), bg.sum(dim=1)
    fg_idx = torch.sort(torch.where(fg, fg_order, 2.0), dim=1,
                        stable=True).indices
    bg_idx = torch.sort(torch.where(bg, bg_order, 2.0), dim=1,
                        stable=True).indices
    fg_draw = torch.floor(fg_u * n_fg.clamp(min=1)[:, None].float()).long()
    bg_draw = torch.floor(bg_u * n_bg.clamp(min=1)[:, None].float()).long()
    both = (n_fg > 0) & (n_bg > 0)
    fg_this = torch.where(both, n_fg.clamp(max=fg_per),
                          torch.where(n_fg > 0, r, 0))[:, None]
    i = torch.arange(r, device=dev)[None, :].expand(b, r)
    fg_pick = torch.where((n_bg > 0)[:, None],
                          torch.gather(fg_idx, 1, i.clamp(max=n_p - 1)),
                          torch.gather(fg_idx, 1, fg_draw))
    picks = torch.where(i < fg_this, fg_pick,
                        torch.gather(bg_idx, 1, bg_draw))
    labels = torch.where(i < fg_this, torch.gather(cls, 1, picks), 0)
    out = torch.gather(all_rois, 1, picks[..., None].expand(-1, -1, 5))
    idx = torch.arange(b, dtype=out.dtype, device=dev)
    out = torch.cat([idx[:, None, None].expand(b, r, 1), out[..., 1:]], 2)
    gt_sel = torch.gather(gt[..., :4], 1, torch.gather(assign, 1, picks)
                          [..., None].expand(-1, -1, 4))
    means = torch.tensor(t["BBOX_NORMALIZE_MEANS"], device=dev)
    stds = torch.tensor(t["BBOX_NORMALIZE_STDS"], device=dev)
    targets = (bx.encode(out[..., 1:5], gt_sel) - means) / stds
    inside = torch.where(labels[..., None] > 0, torch.tensor(
        t["BBOX_INSIDE_WEIGHTS"], device=dev), 0.0)
    return ProposalTargets(out, labels, targets, inside, (inside > 0).float())


def smooth_l1(pred, target, inside, outside, sigma, dims):
    s2 = sigma ** 2
    diff = inside * (pred - target)
    a = diff.abs()
    small = (a < 1.0 / s2).float()
    per = diff ** 2 * (s2 / 2.0) * small + (a - 0.5 / s2) * (1.0 - small)
    return (outside * per).sum(dim=dims).mean()


def cross_entropy(logits, labels, valid):
    logp = torch.log_softmax(logits.float(), dim=-1)
    ce = -torch.gather(logp, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    v = valid.float()
    return (ce * v).sum() / v.sum().clamp(min=1.0)


def margin_ranking(prob, labels, margin):
    lab = labels.float()
    gt_map = (lab[:, None, :] - lab[:, :, None]).abs()
    pr_map = (prob[:, None, :] - prob[:, :, None]).abs()
    return torch.clamp(-(2.0 * gt_map - 1.0) * (pr_map - gt_map) + margin,
                       min=0.0).mean()


def step_loss(W, cfg, batch, rois_fn, stream: Stream, prec=R.F32):
    """(the five losses' sum, the RPN's outputs) of one training forward.
    rois_fn(rpn, im_info) gives the proposal layer's rois [B, post, 5]: the
    program's, where the reference follows it, or `R.proposals`'."""
    m = cfg["model"]
    dev = W["rpn.conv.weight"].device
    image = torch.as_tensor(batch["image"], device=dev)
    query = torch.as_tensor(batch["query"], device=dev)
    info = torch.as_tensor(batch["im_info"], device=dev)
    gt = torch.as_tensor(batch["gt_boxes"], device=dev)
    b = image.shape[0]
    variant = m["backbone"]
    fi = R.backbone(W, R.to_rgb_image(image), prec, variant)
    fq = R.backbone(W, R.to_rgb_image(query), prec, variant)
    half = m["channels"] // 2
    hi, wi = fi.shape[2:]
    hq, wq = fq.shape[2:]
    drops = (stream.attn(b, hi * wi, hq * wq, half, m["t_n_head"]),
             stream.attn(b, hq * wq, hi * wi, half, m["t_n_head"]))
    ni, nq = R.coattention(W, fi, fq, prec, drops)
    rpn = R.rpn_head(W, ni, prec)
    anchors = R.anchors_for(cfg, hi, wi, dev)
    at = anchor_targets(cfg, anchors, gt, info, stream)
    cls = rpn.cls_logits.permute(0, 1, 2, 4, 3).reshape(b, -1, 2)
    rpn_cls = cross_entropy(cls, at.labels, at.labels != -1)
    rpn_box = smooth_l1(rpn.deltas.reshape(b, -1, 4), at.targets, at.inside,
                        at.outside, 3.0, (1, 2))
    rois = rois_fn(R.RPN(rpn.cls_logits.detach(), rpn.deltas.detach()), info)
    pt = proposal_targets(cfg, rois, gt, stream)
    h = R.head(W, cfg, R.Features(ni, nq, rpn), pt.rois, prec,
               drop=stream.site(m["t_d_model"], m["t_n_head"]))
    r = pt.rois.shape[1]
    rcnn_cls = cross_entropy(h.logits.reshape(-1, 2), pt.labels.reshape(-1),
                             torch.ones(b * r, dtype=torch.bool, device=dev))
    margin = 3.0 * margin_ranking(h.prob, pt.labels, cfg["TRAIN"]["MARGIN"])
    rcnn_box = smooth_l1(h.deltas.reshape(-1, 4), pt.targets.reshape(-1, 4),
                         pt.inside.reshape(-1, 4), pt.outside.reshape(-1, 4),
                         1.0, (1,))
    return rpn_cls + rpn_box + rcnn_cls + margin + rcnn_box, rpn


def is_bias(key: str) -> bool:
    return key.rsplit(".", 1)[-1] == "bias"


class SGD:
    """torch.optim.SGD's update as AIT's optimizer groups it: weights at lr
    with WEIGHT_DECAY, biases at lr * (1 + DOUBLE_BIAS) with WEIGHT_DECAY
    only under BIAS_DECAY; momentum on the decayed gradient."""

    def __init__(self, cfg, params: Dict[str, torch.Tensor]):
        t = cfg["TRAIN"]
        self.t, self.params, self.buf = t, params, {}

    def decay(self, key):
        t = self.t
        return (t["WEIGHT_DECAY"] if not is_bias(key) or t["BIAS_DECAY"]
                else 0.0)

    def step(self, lr):
        t = self.t
        with torch.no_grad():
            for k, p in self.params.items():
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                d = g + self.decay(k) * p
                self.buf[k] = (d.clone() if k not in self.buf else
                               t["MOMENTUM"] * self.buf[k] + d)
                mult = 1.0 + int(t["DOUBLE_BIAS"]) if is_bias(k) else 1.0
                p -= lr * mult * self.buf[k]


def lrs(train: Dict, steps: int):
    """The base lr of steps 0..steps-1 from the configuration's `train`
    group: lr * gamma ** floor(step / (lr_decay_step_epochs *
    steps_per_epoch)), AIT's step decay, with no warmup."""
    every = int(train["lr_decay_step_epochs"]) * int(train["steps_per_epoch"])
    return [float(train["lr"]) * float(train["gamma"]) ** (k // every)
            if every > 0 else float(train["lr"]) for k in range(steps)]


def trainable(W):
    return {k: v for k, v in W.items() if not frozen(k)}


def run_steps(W, cfg, batches, rois_of, generator, lrs, prec=R.F32):
    """SGD steps from the weights W (float32, modified in place): one per
    batch, each with its lr and rois_of(step, rpn, im_info) the proposal
    layer's rois.  Returns (losses, the first step's gradients, each step's
    RPN outputs)."""
    params = trainable(W)
    for p in params.values():
        p.requires_grad_(True)
    opt = SGD(cfg, params)
    stream = Stream(generator, 1.0 - cfg["model"]["t_dropout"])
    losses, first, rpns = [], None, []
    for k, (batch, lr) in enumerate(zip(batches, lrs)):
        for p in params.values():
            p.grad = None
        loss, rpn = step_loss(W, cfg, batch,
                              lambda r, info: rois_of(k, r, info), stream,
                              prec)
        rpns.append(R.RPN(rpn.cls_logits.detach(), rpn.deltas.detach()))
        loss.backward()
        losses.append(float(loss.detach()))
        if first is None:
            first = {key: (p.grad.detach().clone() if p.grad is not None
                           else torch.zeros_like(p))
                     for key, p in params.items()}
        opt.step(lr)
    for p in params.values():
        p.requires_grad_(False)
        p.grad = None
    return losses, first, rpns
