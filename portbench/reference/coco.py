"""AIT's COCO model in plain PyTorch, float32, as a yardstick.

The COCO recipe (github.com/CAIVIAC/AIT: cfgs/res50_1.yml, train_coco.sh,
test_coco.sh --a 4, lib/model/faster_rcnn/faster_rcnn_coatt_transformer_sk.py)
is the VOC model of model.py with two changes: the co-attention is the
non-local one (faster_rcnn_coatt_transformer_sk.py:104-157,
blocks_coatt_transformer_sk.py:17-122), and the anchors are COCO's, scales
(4, 8, 16, 32) at three ratios, 12 a feature cell, so the RPN head is
wider.  Everything else is model.py's functions, used as they are.

The non-local co-attention: one 1x1 embedding `emb` (1024 -> 512) shared by
both sides, `rho` on the query and `phi` on the image (1024 -> 512), the
relation rho(q) phi(i)^T [Nq, Ni] normalized by 'division' (each
direction by the other side's token count), each side's relation-weighted
sum of the other side's embedding, a 1x1 convolution back to 1024
(`theta_conv` on the image, `omega_conv` on the query), a GroupNorm of 32
groups, and the input added.

Departures from the published code, each where the port departs too:
- the relation's second products take the normalized relation as it is;
  the program rounds it to its compute dtype first (bf16), as the model's
  JAX code does;
- `detect` takes U images and A query shots each ([U, A, q, q, 3]) and runs
  each pair with its own image backbone pass, as the published test loop
  does once a shot; the program runs the image backbone once an image and
  gathers its features to the pairs.  The reference is the plain form of
  the fused program and does not use the gather.

Every forward here runs in float32: `features` turns TF32 off for products
and convolutions.  Nothing here reads the program under test.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import model as R
from .params import param_shapes

GN_GROUPS, GN_EPS = 32, 1e-5
GN_LEAVES = ("coattention.theta_gn.GroupNorm_0",
             "coattention.omega_gn.GroupNorm_0")


def num_anchors(cfg) -> int:
    return len(cfg["ANCHOR_SCALES"]) * len(cfg["ANCHOR_RATIOS"])


def coco_param_shapes(cfg):
    """param_shapes with the non-local co-attention's leaves in place of
    the MHA co-attention's (faster_rcnn_coatt_transformer_sk.py:104-157);
    the RPN head already takes the configuration's anchor count."""
    ch = cfg["model"]["channels"]
    d = ch // 2
    out = {k: v for k, v in param_shapes(cfg).items()
           if not k.startswith("coattention.")}
    for name, cin, cout in (("emb", ch, d), ("rho", ch, d), ("phi", ch, d),
                            ("theta_conv", d, ch), ("omega_conv", d, ch)):
        out[f"coattention.{name}.weight"] = (cout, cin, 1, 1)
        out[f"coattention.{name}.bias"] = (cout,)
    for gn in GN_LEAVES:
        out[gn + ".scale"] = (ch,)
        out[gn + ".bias"] = (ch,)
    return out


def group_norm(W, name, x):
    return F.group_norm(x, GN_GROUPS, W[name + ".scale"], W[name + ".bias"],
                        GN_EPS)


def nonlocal_coattention(W, img, qry, prec):
    """[B, 1024, Hi, Wi], [B, 1024, Hq, Wq] -> the same shapes."""
    b, c, hi, wi = img.shape
    hq, wq = qry.shape[2:]
    n = "coattention."

    def tokens(name, x):
        return R.conv(W, n + name, x, prec).flatten(2).transpose(1, 2)

    emb_img, emb_qry = tokens("emb", img), tokens("emb", qry)
    rho_qry, phi_img = tokens("rho", qry), tokens("phi", img)
    rel = R.mm(rho_qry, phi_img.transpose(1, 2), prec)      # [B, Nq, Ni]
    n_q, n_i = rel.shape[1], rel.shape[2]
    q2i = rel / n_i
    i2q = rel.transpose(1, 2) / n_q
    non_img = R.mm(i2q, emb_qry, prec)                      # [B, Ni, d]
    non_qry = R.mm(q2i, emb_img, prec)                      # [B, Nq, d]
    d = non_img.shape[-1]
    non_img = non_img.transpose(1, 2).reshape(b, d, hi, wi)
    non_qry = non_qry.transpose(1, 2).reshape(b, d, hq, wq)
    non_img = group_norm(W, n + "theta_gn.GroupNorm_0",
                         R.conv(W, n + "theta_conv", non_img, prec))
    non_qry = group_norm(W, n + "omega_gn.GroupNorm_0",
                         R.conv(W, n + "omega_conv", non_qry, prec))
    return non_img + img, non_qry + qry


def features(W, cfg, image, query, prec=R.F32):
    """Backbone on both inputs of each pair (image [P, ...] and query
    [P, ...] row for row), the non-local co-attention and the RPN head of
    12 anchors a cell."""
    set_f32()
    variant = cfg["model"]["backbone"]
    fi = R.backbone(W, R.to_rgb_image(image), prec, variant)
    fq = R.backbone(W, R.to_rgb_image(query), prec, variant)
    ni, nq = nonlocal_coattention(W, fi, fq, prec)
    return R.Features(ni, nq, R.rpn_head(W, ni, prec, num_anchors(cfg)))


def pairs(image, query, im_info):
    """U images, [U, A, ...] shots and [U, 3] im_info -> the U * A pairs,
    pair-major (shot a of image u at u * A + a)."""
    u, a = query.shape[:2]
    return (torch.repeat_interleave(image, a, dim=0),
            query.reshape((u * a,) + tuple(query.shape[2:])),
            torch.repeat_interleave(im_info, a, dim=0))


def detect(W, cfg, image, query, im_info, prec=R.F32, chunk=None):
    """The whole eval forward of U images and their A shots each, every pair
    with its own image backbone pass: (features, rois, head, dets, valid),
    pair-major."""
    image, query, info = pairs(torch.as_tensor(image),
                               torch.as_tensor(query),
                               torch.as_tensor(im_info))
    feats = features(W, cfg, image, query, prec)
    rois = R.proposals(cfg, feats.rpn, info, train=False)
    h = R.head(W, cfg, feats, rois, prec, chunk=chunk)
    dets, valid = R.postprocess(cfg, rois, h.prob, h.deltas, info)
    return feats, rois, h, dets, valid


def set_f32():
    """The reference runs in float32: TF32 off for products and
    convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
