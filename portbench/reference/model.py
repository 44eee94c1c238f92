"""The AIT one-shot detector in plain PyTorch, float32, as a yardstick.

AIT (Chen, Hsieh, Liu, "Adaptive Image Transformer for One-Shot Object
Detection", CVPR 2021; github.com/CAIVIAC/AIT): a siamese ResNet with
frozen BatchNorm, a co-attention of two multi-head attentions with the
selective-head gate, an RPN and its proposal layer, ROI Align, the AIT
transformer (one encoder and one decoder layer: selective-head attentions,
post-LayerNorm FFNs), an SKNet block on each stream, ResNet's layer4 as the
top, and the match and box heads.

Everything is a function of a weight dict `W` whose keys and layouts are the
benchmark's (weights.py): convolution kernels [O, I/g, kh, kw], dense
weights [O, I], attention and FFN kernels [in, out].  Tensors are NCHW inside
the convolutional parts.  The whole forward runs in float32 (the caller
turns TF32 off), except where `Prec` rounds the operands of every product:
Prec("fp8") is the lower-precision control.  Nothing here reads the program
under test.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import boxes as bx

NORM_MEAN = (0.485, 0.456, 0.406)
NORM_STD = (0.229, 0.224, 0.225)
STAGES = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}
BN_EPS, LN_EPS = 1e-5, 1e-6
E4M3_MAX = 448.0


class Prec:
    """How the operands of each product are rounded: "f32" not at all,
    "fp8" to float8 e4m3 with one scale per tensor (its largest magnitude
    mapped to 448).  Sums stay float32, and in training the gradient
    passes the rounding unchanged."""

    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "fp8"):
            raise ValueError(f"precision {mode!r}")
        self.mode = mode

    def __call__(self, x):
        x = x.float()
        if self.mode == "f32":
            return x
        with torch.no_grad():
            scale = x.abs().amax().clamp(min=1e-30) / E4M3_MAX
            q = (x / scale).to(torch.float8_e4m3fn).float() * scale
        # the rounded value forward; the gradient passes as it is
        return x + (q - x).detach() if x.requires_grad else q


F32 = Prec("f32")


# ---------------------------------------------------------------- layers


def conv(W, name, x, prec, stride=1, padding=0, groups=1):
    b = W.get(name + ".bias")
    return F.conv2d(prec(x), prec(W[name + ".weight"]), b, stride, padding,
                    1, groups)


def dense(W, name, x, prec):
    return F.linear(prec(x), prec(W[name + ".weight"]), W[name + ".bias"])


def mm(a, b, prec):
    return prec(a) @ prec(b)


def frozen_bn(W, name, x):
    w = W[name + ".scale"] * torch.rsqrt(W[name + ".var"] + BN_EPS)
    b = W[name + ".bias"] - W[name + ".mean"] * w
    return x * w[None, :, None, None] + b[None, :, None, None]


def layer_norm(x, W, name):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + LN_EPS) * W[name + ".scale"] +
            W[name + ".bias"])


# ---------------------------------------------------------------- ResNet


def bottleneck(W, name, x, prec, stride):
    y = torch.relu(frozen_bn(W, name + ".bn1",
                             conv(W, name + ".conv1", x, prec, stride)))
    y = torch.relu(frozen_bn(W, name + ".bn2",
                             conv(W, name + ".conv2", y, prec, 1, 1)))
    y = frozen_bn(W, name + ".bn3", conv(W, name + ".conv3", y, prec))
    if name + ".downsample_conv.weight" in W:
        x = frozen_bn(W, name + ".downsample_bn",
                      conv(W, name + ".downsample_conv", x, prec, stride))
    return torch.relu(y + x)


def stage(W, name, x, prec, blocks, stride):
    for i in range(blocks):
        x = bottleneck(W, f"{name}.block{i}", x, prec, stride if i == 0 else 1)
    return x


def to_rgb_image(x):
    """uint8 NHWC RGB, or its space-to-depth form [B, H/2, W/2, 12] whose
    plane dy*6 + dx*3 + c holds pixel (2i + dy, 2j + dx) of channel c ->
    float32 normalized NCHW [B, 3, H, W]."""
    x = x.float()
    if x.shape[-1] == 12:
        b, h, w, _ = x.shape
        x = x.reshape(b, h, w, 2, 2, 3).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, 2 * h, 2 * w, 3)
    mean = torch.tensor(NORM_MEAN, device=x.device)
    std = torch.tensor(NORM_STD, device=x.device)
    return ((x / 255.0 - mean) / std).permute(0, 3, 1, 2)


def backbone(W, x, prec, variant):
    """Normalized NCHW image -> stride-16 features [B, 1024, H/16, W/16]."""
    n1, n2, n3, _ = STAGES[variant]
    x = conv(W, "backbone.conv1", x, prec, 2, 3)
    x = torch.relu(frozen_bn(W, "backbone.bn1", x))
    x = F.max_pool2d(x, 3, 2, 0, ceil_mode=True)
    x = stage(W, "backbone.layer1", x, prec, n1, 1)
    x = stage(W, "backbone.layer2", x, prec, n2, 2)
    return stage(W, "backbone.layer3", x, prec, n3, 2)


def top(W, x, prec, variant):
    """layer4 and the spatial mean: [N, 1024, h, w] -> [N, 2048]."""
    return stage(W, "top.layer4", x, prec, STAGES[variant][3], 2).mean(
        dim=(2, 3))


# ---------------------------------------------------------------- attention


def attention(W, name, q_in, kv_in, prec, mask=None, drop=None, n_head=8,
              d_k=64, d_v=64):
    """Multi-head attention with the selective-head gate and post-LN
    (AIT's SubLayers.py): q_in [B, Tq, D], kv_in [B, Tk, D], mask
    broadcastable to [B, Tq, Tk] (True attends).  drop: (attn_keep [B, H, Tq,
    Tk], out_keep [B, Tq, D], keep_prob) or None."""
    b, tq, d = q_in.shape
    tk = kv_in.shape[1]
    q = mm(q_in, W[name + ".w_qs.kernel"], prec).reshape(b, tq, n_head, d_k)
    k = mm(kv_in, W[name + ".w_ks.kernel"], prec).reshape(b, tk, n_head, d_k)
    v = mm(kv_in, W[name + ".w_vs.kernel"], prec).reshape(b, tk, n_head, d_v)
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    s = mm(q / math.sqrt(d_k), k.transpose(-1, -2), prec)
    if mask is not None:
        s = torch.where(mask[:, None], s, -1e9)
    p = torch.softmax(s, dim=-1)
    if drop is not None:
        p = p * drop[0] / drop[2]
    o = mm(p, v, prec)                                   # [B, H, Tq, d_v]
    g = o.sum(dim=1).mean(dim=1)                          # [B, d_v]
    g = mm(g, W[name + ".sh.sk.kernel"], prec) + W[name + ".sh.sk.bias"]
    g = torch.softmax(g.reshape(b, n_head, d_v), dim=1)
    o = (o * g[:, :, None, :]).sum(dim=1)                 # [B, Tq, d_v]
    y = mm(o, W[name + ".fc.kernel"], prec)
    if drop is not None:
        y = y * drop[1] / drop[2]
    return layer_norm(y + q_in, W, name + ".LayerNorm_0")


def ffn(W, name, x, prec, keep=None, keep_prob=1.0):
    """Post-LN FFN: LN(x + W2 relu(W1 x + b1) + b2), output dropout."""
    h = torch.relu(mm(x, W[name + ".w_1.kernel"], prec) +
                   W[name + ".w_1.bias"])
    y = mm(h, W[name + ".w_2.kernel"], prec) + W[name + ".w_2.bias"]
    if keep is not None:
        y = y * keep / keep_prob
    return layer_norm(y + x, W, name + ".LayerNorm_0")


def coattention(W, img, qry, prec, drops=(None, None)):
    """[B, 1024, Hi, Wi], [B, 1024, Hq, Wq] -> the same shapes."""
    b, c, hi, wi = img.shape
    hq, wq = qry.shape[2:]
    ei = conv(W, "coattention.img_emb", img, prec).flatten(2).transpose(1, 2)
    eq = conv(W, "coattention.qry_emb", qry, prec).flatten(2).transpose(1, 2)
    enc_img = attention(W, "coattention.q2i_attn", ei, eq, prec,
                        drop=drops[0])
    enc_qry = attention(W, "coattention.i2q_attn", eq, ei, prec,
                        drop=drops[1])
    enc_img = dense(W, "coattention.img_trans", enc_img, prec)
    enc_qry = dense(W, "coattention.qry_trans", enc_qry, prec)
    return (enc_img.transpose(1, 2).reshape(b, c, hi, wi),
            enc_qry.transpose(1, 2).reshape(b, c, hq, wq))


def sinusoid(n_position, d):
    pos = torch.arange(n_position, dtype=torch.float64)[:, None]
    dim = torch.arange(d)[None, :]
    angle = pos / torch.pow(10000.0, 2 * (dim // 2) / d)
    table = torch.where(dim % 2 == 0, torch.sin(angle), torch.cos(angle))
    return table.float()


def transformer(W, props, qfeat, prec, cfg, drop=None):
    """The AIT transformer: props [N, 1024, 7, 7] (N = B * R, image-major),
    qfeat [B, 1024, hq, wq] -> [N, 1024, hq, wq].  The proposal tokens are
    padded to a multiple of 8 and masked as keys; the decoder runs the
    query tokens of each proposal's image with a causal self-attention.
    drop: a callable site -> mask arguments, or None."""
    m = cfg["model"]
    d = m["t_d_model"]
    n, _, hp, wp = props.shape
    b, _, hq, wq = qfeat.shape
    r = n // b
    heads = dict(n_head=m["t_n_head"], d_k=m["t_d_k"], d_v=m["t_d_v"])
    src = conv(W, "transformer.enc_emb", props, prec).flatten(2)
    trg = conv(W, "transformer.dec_emb", qfeat, prec).flatten(2)
    src, trg = src.transpose(1, 2), trg.transpose(1, 2)
    n_s, n_t = src.shape[1], trg.shape[1]
    n_enc = -(-n_s // 8) * 8
    src = F.pad(src, (0, 0, 0, n_enc - n_s))
    dev = src.device
    pos = sinusoid(m["t_n_position"], d).to(dev)
    src_mask = (torch.arange(n_enc, device=dev) < n_s)[None, None, :]
    causal = torch.tril(torch.ones((n_t, n_t), dtype=torch.bool, device=dev))
    causal = causal[None] if m["t_causal_mask"] else None
    site = drop or (lambda *a: None)

    enc = src + pos[:n_enc]
    enc = _keep(enc, site("glue", n, n_enc))
    enc = layer_norm(enc, W, "transformer.enc_in_ln")
    for i in range(m["t_n_layers"]):
        nm = f"transformer.enc_layer{i}"
        enc = attention(W, nm + ".slf_attn", enc, enc, prec, src_mask,
                        site("attn", n, n_enc, n_enc), **heads)
        enc = ffn(W, nm + ".pos_ffn", enc, prec, *_ffn_keep(
            site("ffn", n, n_enc)))
    dec = trg + pos[:n_t]
    per_image = drop is None or cfg["tpu"]["dec_prefix_per_image"]
    rows = b if per_image else n
    if not per_image:
        dec = torch.repeat_interleave(dec, r, dim=0)
    dec = _keep(dec, site("glue", rows, n_t))
    dec = layer_norm(dec, W, "transformer.dec_in_ln")
    for i in range(m["t_n_layers"]):
        nm = f"transformer.dec_layer{i}"
        dec = attention(W, nm + ".slf_attn", dec, dec, prec, causal,
                        site("attn", dec.shape[0], n_t, n_t), **heads)
        if dec.shape[0] != n:
            dec = torch.repeat_interleave(dec, r, dim=0)
        dec = attention(W, nm + ".enc_attn", dec, enc, prec, src_mask,
                        site("attn", n, n_t, n_enc), **heads)
        dec = ffn(W, nm + ".pos_ffn", dec, prec, *_ffn_keep(
            site("ffn", n, n_t)))
    out = dec.transpose(1, 2).reshape(n, d, hq, wq)
    return conv(W, "transformer.dec_trans", out, prec)


def _keep(x, mask):
    return x if mask is None else x * mask[0] / mask[1]


def _ffn_keep(mask):
    return (None, 1.0) if mask is None else mask


def sk_block(W, name, x, prec):
    """SKNet as AIT's blocks_coatt_transformer_sk.py returns it: the sum of
    the two grouped branches' squares."""
    f0 = torch.relu(conv(W, name + ".conv0", x, prec, groups=8))
    f1 = torch.relu(conv(W, name + ".conv1", x, prec, 1, 1, groups=8))
    return f0 * f0 + f1 * f1


# ---------------------------------------------------------------- RPN, ROIs


def roi_align(feat, rois, out_size=7, scale=1.0 / 16):
    """ROI Align as AIT's CUDA kernel computes it (ROIAlign_cuda.cu): no
    half-pixel shift, rois at least 1x1, the adaptive grid ceil(bin)
    samples per bin and axis, samples beyond [-1, size] zero and those in
    [-1, 0] clamped.  Bilinear sampling is separable, so each roi is two
    interpolation matrices contracted with its image's map.  feat [B, C, H,
    W], rois [B, R, 4] -> [B * R, C, out, out]."""
    _, _, hh, ww = feat.shape
    outs = []
    for fm, rb in zip(feat, rois.float()):
        x1, y1, x2, y2 = (rb * scale).unbind(-1)
        bw = (x2 - x1).clamp(min=1.0) / out_size
        bh = (y2 - y1).clamp(min=1.0) / out_size
        wy = _axis_weights(y1, bh, out_size, hh)          # [R, out, H]
        wx = _axis_weights(x1, bw, out_size, ww)          # [R, out, W]
        outs.append(torch.einsum("rih,chw,rjw->rcij", wy, fm, wx))
    return torch.cat(outs)


def _axis_weights(start, bin_size, n_bins, size):
    max_grid = -(-size // n_bins)
    grid = torch.ceil(bin_size).clamp(1, max_grid)            # [R]
    s = torch.arange(max_grid, device=start.device, dtype=torch.float32)
    ph = torch.arange(n_bins, device=start.device, dtype=torch.float32)
    pos = (start[:, None, None] + ph[None, :, None] * bin_size[:, None, None]
           + (s[None, None, :] + 0.5) * bin_size[:, None, None] /
           grid[:, None, None])                              # [R, out, g]
    used = s[None, None, :] < grid[:, None, None]
    zero = (pos < -1.0) | (pos > size) | ~used
    pos = pos.clamp(0.0, size - 1.0)
    low = torch.floor(pos)
    frac = pos - low
    ax = torch.arange(size, device=start.device, dtype=torch.float32)
    w = ((ax == low[..., None]) * (1.0 - frac[..., None]) +
         (ax == low[..., None] + 1.0) * frac[..., None])
    w = torch.where(zero[..., None], 0.0, w)
    return w.sum(dim=2) / grid[:, None, None]


class RPN(NamedTuple):
    cls_logits: torch.Tensor    # [B, H, W, 2, A] (background, foreground)
    deltas: torch.Tensor        # [B, H, W, 4 A]


def rpn_head(W, feat, prec, num_anchors=9):
    x = torch.relu(conv(W, "rpn.conv", feat, prec, 1, 1))
    cls = conv(W, "rpn.cls_score", x, prec).permute(0, 2, 3, 1)
    bbox = conv(W, "rpn.bbox_pred", x, prec).permute(0, 2, 3, 1)
    b, h, w, _ = cls.shape
    return RPN(cls.reshape(b, h, w, 2, num_anchors), bbox)


def anchors_for(cfg, fh, fw, device):
    return torch.from_numpy(bx.all_anchors(
        fh, fw, cfg["FEAT_STRIDE"][0], cfg["ANCHOR_RATIOS"],
        cfg["ANCHOR_SCALES"])).to(device)


def proposals(cfg, rpn: RPN, im_info, train: bool):
    """Decode every anchor, clip it, drop anchors centred beyond the true
    image, NMS: rois [B, post, 5] (image index, x1, y1, x2, y2), rows past
    the survivors zero but for the index."""
    b, fh, fw, _, a = rpn.cls_logits.shape
    t = cfg["TRAIN" if train else "TEST"]
    anchors = anchors_for(cfg, fh, fw, rpn.cls_logits.device)
    scores = torch.softmax(rpn.cls_logits.float(), dim=3)[..., 1, :]
    scores = scores.reshape(b, -1)
    deltas = rpn.deltas.float().reshape(b, -1, 4)
    info = im_info.float()
    props = bx.clip(bx.decode(anchors[None], deltas), info[:, None, :2])
    cx = 0.5 * (anchors[:, 0] + anchors[:, 2])
    cy = 0.5 * (anchors[:, 1] + anchors[:, 3])
    inside = (cx[None] < info[:, None, 1]) & (cy[None] < info[:, None, 0])
    kept, _, _ = bx.nms_topk(props, scores, inside, t["RPN_NMS_THRESH"],
                             t["RPN_PRE_NMS_TOP_N"], t["RPN_POST_NMS_TOP_N"])
    idx = torch.arange(b, device=kept.device, dtype=kept.dtype)
    return torch.cat([idx[:, None, None].expand(b, kept.shape[1], 1), kept],
                     dim=-1)


# ---------------------------------------------------------------- detector


class Features(NamedTuple):
    img: torch.Tensor           # co-attended image features [B, 1024, h, w]
    qry: torch.Tensor           # co-attended query features [B, 1024, 8, 8]
    rpn: RPN


def features(W, cfg, image, query, prec=F32, drops=(None, None)):
    """Backbone on both inputs, co-attention and the RPN head."""
    variant = cfg["model"]["backbone"]
    fi = backbone(W, to_rgb_image(image), prec, variant)
    fq = backbone(W, to_rgb_image(query), prec, variant)
    ni, nq = coattention(W, fi, fq, prec, drops)
    return Features(ni, nq, rpn_head(W, ni, prec))


class Head(NamedTuple):
    logits: torch.Tensor        # [B, R, 2] match logits
    prob: torch.Tensor          # [B, R] match probability
    deltas: torch.Tensor        # [B, R, 4] box deltas (normalized)
    pvec: torch.Tensor          # [B, R, 2048] the top's roi vectors
    qvec: torch.Tensor          # [B, 2048] the top's query vectors


def head(W, cfg, feats: Features, rois, prec=F32, drop=None,
         chunk: Optional[int] = None):
    """ROI Align on the proposal layer's rois [B, R, 5], the transformer,
    SKNet, the top and the heads.  chunk: images per pass (memory)."""
    b, r = rois.shape[:2]
    variant = cfg["model"]["backbone"]
    qf = sk_block(W, "sk.sk_query", feats.qry, prec)
    qvec = top(W, qf, prec, variant)                         # [B, 2048]
    chunk = chunk or b
    logits, deltas, pvecs = [], [], []
    for s in range(0, b, chunk):
        e = min(b, s + chunk)
        props = roi_align(feats.img[s:e], rois[s:e, :, 1:5],
                          cfg["POOLING_SIZE"], 1.0 / cfg["FEAT_STRIDE"][0])
        x = transformer(W, props, feats.qry[s:e], prec, cfg, drop)
        x = sk_block(W, "sk.sk_props", x, prec)
        pvec = top(W, x, prec, variant).reshape(e - s, r, -1)
        pvecs.append(pvec)
        deltas.append(dense(W, "bbox_pred_head", pvec, prec))
        stack = torch.cat([pvec, qvec[s:e, None, :].expand_as(pvec)], dim=-1)
        logits.append(dense(W, "cls_score_1",
                            dense(W, "cls_score_0", stack, prec), prec))
    logits = torch.cat(logits)
    return Head(logits, torch.softmax(logits, dim=-1)[..., 1],
                torch.cat(deltas), torch.cat(pvecs), qvec)


def postprocess(cfg, rois, prob, deltas, im_info, score_thresh=0.0):
    """AIT's test_net: un-normalize and decode the deltas against the rois,
    clip, rescale to the original image, NMS at TEST.NMS, keep the
    MAX_PER_IMAGE best (every score tied with the last one kept too).
    -> (dets [B, R, 5] (x1, y1, x2, y2, score), valid [B, R])."""
    t = cfg["TRAIN"]
    means = torch.tensor(t["BBOX_NORMALIZE_MEANS"], device=rois.device)
    stds = torch.tensor(t["BBOX_NORMALIZE_STDS"], device=rois.device)
    info = im_info.float()
    boxes = bx.decode(rois[..., 1:5].float(), deltas.float() * stds + means)
    boxes = bx.clip(boxes, info[:, None, :2]) / info[:, None, 2:3]
    scores = prob.float()
    valid = (rois[..., 1:5] != 0).any(dim=-1) & (scores > score_thresh)
    r = boxes.shape[1]
    ob, os_, ov = bx.nms_topk(boxes, scores, valid, cfg["TEST"]["NMS"], r, r)
    cap = cfg["TEST"]["MAX_PER_IMAGE"]
    if r > cap:
        ranked = torch.where(ov, os_, -torch.inf)
        kth = torch.sort(ranked, dim=1, descending=True).values[:, cap - 1]
        cut = torch.where(ov.sum(dim=1) > cap, kth, -torch.inf)
        ov = ov & (os_ >= cut[:, None])
    return torch.cat([ob, os_[..., None]], dim=-1), ov


def detect(W: Dict[str, torch.Tensor], cfg, image, query, im_info,
           prec=F32, chunk=None):
    """The whole eval forward: (features, rois, head, dets, valid)."""
    feats = features(W, cfg, image, query, prec)
    rois = proposals(cfg, feats.rpn, im_info, train=False)
    h = head(W, cfg, feats, rois, prec, chunk=chunk)
    dets, valid = postprocess(cfg, rois, h.prob, h.deltas, im_info)
    return feats, rois, h, dets, valid
