"""The one-shot detector (counterpart of ait_tpu/models/detector.py::
AITDetector).

Siamese ResNet backbone -> MHA co-attention -> RPN -> proposal layer (NMS
kernel) -> ROI Align -> AIT transformer (attention, FFN and glue kernels)
-> SKNet -> ResNet layer4 top -> match and box heads.

Inputs are NHWC: image [B, H, W, 3] (a padded canvas, true extent in
im_info) or, as the loader ships it with `tpu.host_s2d`, its space-to-depth
form [B, H/2, W/2, 12]; query [B, 128, 128, 3]; both uint8 RGB or already
normalized floats; im_info [B, 3] = (h, w, scale); in training gt_boxes
[B, G, 5] (zero-padded, binary class in column 4).  Returns a DetectorOut:
rois [B, R, 5], cls_prob [B, R, 1], bbox_pred [B, R, 4] and, in training,
the five losses and rois_label.

Training takes the TRAIN tops of the proposal layer, samples anchor and
proposal targets with the caller's `torch.Generator` (models/targets.py),
and runs the transformer's kernels through their autograd Functions.
Dropout at model.t_dropout (the co-attention's two attentions, and every
glue, attention and FFN of the transformer, inside their kernels) draws from
the same generator: one `Dropout` (models/dropout.py) goes down the forward,
and the sites draw their seeds from it in call order (co-attention, then,
after the target sampling, the transformer).  Eval draws nothing.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ait_tpu_torch.config import Config
from ait_tpu_torch.models import losses as L
from ait_tpu_torch.models.ait_transformer import AITTransformer
from ait_tpu_torch.models.coattention import MHACoAttention
from ait_tpu_torch.models.dropout import Dropout
from ait_tpu_torch.models.layers import Dense
from ait_tpu_torch.models.resnet import ResNetBackbone, ResNetTop
from ait_tpu_torch.models.rpn import RPNHead, proposal_layer
from ait_tpu_torch.models.sknet import SKNet
from ait_tpu_torch.models.targets import anchor_targets, proposal_targets
from ait_tpu_torch.ops.anchors import shifted_anchors
from ait_tpu_torch.ops.roi_align import roi_align

# torchvision normalization constants (blob.py:42-48), applied on the
# device to uint8 inputs (data/transforms.py holds them for the host)
_NORM_MEAN = (0.485, 0.456, 0.406)
_NORM_STD = (0.229, 0.224, 0.225)


def _to_model_input(x, dtype):
    """uint8 -> (x / 255 - mean) / std; a space-to-depth image carries 4
    pixel groups of 3 channels, so the constants repeat C / 3 times."""
    if x.dtype == torch.uint8:
        reps = x.shape[-1] // 3
        mean = torch.tensor(_NORM_MEAN * reps, dtype=torch.float32,
                            device=x.device)
        std = torch.tensor(_NORM_STD * reps, dtype=torch.float32,
                           device=x.device)
        x = (x.float() / 255.0 - mean) / std
    return x.to(dtype)


class DetectorOut(NamedTuple):
    rois: torch.Tensor
    cls_prob: torch.Tensor
    bbox_pred: torch.Tensor
    rpn_loss_cls: Optional[torch.Tensor] = None      # training only
    rpn_loss_box: Optional[torch.Tensor] = None
    rcnn_loss_cls: Optional[torch.Tensor] = None
    margin_loss: Optional[torch.Tensor] = None
    rcnn_loss_bbox: Optional[torch.Tensor] = None
    rois_label: Optional[torch.Tensor] = None

    @property
    def total_loss(self):
        return (self.rpn_loss_cls + self.rpn_loss_box + self.rcnn_loss_cls +
                self.margin_loss + self.rcnn_loss_bbox)


def _check_supported(cfg: Config) -> None:
    mc = cfg.model
    unsupported = {
        "model.backbone": mc.backbone != "resnet50",
        "model.coattention": mc.coattention != "mha",
        "model.t_attn_dist": mc.t_attn_dist != "softmax",
        "model.sk_gate": mc.sk_gate != "faithful",
        "model.class_agnostic": not mc.class_agnostic,
        "model.with_contextual_relation": mc.with_contextual_relation,
        "POOLING_MODE": cfg.POOLING_MODE != "align",
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"not ported yet: {', '.join(bad)} (the port covers the flagship "
            "ResNet + MHA co-attention detector)")


class AITDetector(nn.Module):
    def __init__(self, cfg: Config, dtype=torch.float32):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.dtype = dtype
        mc = cfg.model
        ch = mc.channels
        self.backbone = ResNetBackbone(mc.backbone, dtype=dtype)
        self.top = ResNetTop(mc.backbone, dtype=dtype)
        self.coattention = MHACoAttention(ch, mc.t_n_head, mc.t_d_k,
                                          mc.t_d_v, dtype=dtype)
        self.rpn = RPNHead(ch, len(cfg.ANCHOR_SCALES) *
                           len(cfg.ANCHOR_RATIOS), dtype=dtype)
        self.transformer = AITTransformer(
            d_model=mc.t_d_model, d_inner=mc.t_d_inner,
            n_layers=mc.t_n_layers, n_head=mc.t_n_head, d_k=mc.t_d_k,
            d_v=mc.t_d_v, n_position=mc.t_n_position,
            causal_mask=mc.t_causal_mask, channels=ch,
            dec_prefix_per_image=cfg.tpu.dec_prefix_per_image, dtype=dtype)
        self.sk = SKNet(ch, dtype=dtype)
        self.cls_score_0 = Dense(2 * 2048, 8, dtype=dtype)
        self.cls_score_1 = Dense(8, 2, dtype=dtype)
        self.bbox_pred_head = Dense(2048, 4, dtype=dtype)

    def forward(self, image, query, im_info, gt_boxes=None, num_boxes=None,
                *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                pair_image_idx: Optional[torch.Tensor] = None) -> DetectorOut:
        """num_boxes is unused (kept for the JAX call signature); gt_boxes
        and the `generator` (target sampling and dropout) are read in
        training only.  pair_image_idx (eval only): [P] map from pair row to
        image row, so `image` holds only the unique images of the pair batch
        and the image backbone runs once per image, not once per pair."""
        c = self.cfg
        b = query.shape[0]
        if pair_image_idx is not None:
            if train:
                raise ValueError("pair_image_idx is an eval-path feature")
            if pair_image_idx.shape[0] != b:
                raise ValueError(f"pair_image_idx maps "
                                 f"{pair_image_idx.shape[0]} pairs, the "
                                 f"query batch is {b}")
        elif image.shape[0] != b:
            raise ValueError(f"image batch {image.shape[0]} != query batch {b}")
        drop = None
        if train:
            if gt_boxes is None:
                raise ValueError("training needs gt_boxes")
            drop = Dropout(c.model.t_dropout, generator)
        image_feat = self.backbone(_to_model_input(image, self.dtype))
        if pair_image_idx is not None:
            image_feat = image_feat[pair_image_idx]
        query_feat = self.backbone(_to_model_input(query, self.dtype))
        non_img, non_qry = self.coattention(image_feat, query_feat, drop)

        rpn_out = self.rpn(non_img)
        fh, fw = non_img.shape[1], non_img.shape[2]
        anchors = torch.from_numpy(shifted_anchors(
            fh, fw, c.FEAT_STRIDE[0], ratios=c.ANCHOR_RATIOS,
            scales=c.ANCHOR_SCALES)).to(non_img.device)
        tc = c.TRAIN if train else c.TEST
        rois = proposal_layer(
            rpn_out, anchors, im_info,
            pre_nms_topk=tc.RPN_PRE_NMS_TOP_N,
            post_nms_topk=tc.RPN_POST_NMS_TOP_N,
            nms_thresh=tc.RPN_NMS_THRESH)
        if not train:
            return self.head(non_img, non_qry, rois)

        t = c.TRAIN
        at = anchor_targets(
            anchors, gt_boxes, im_info, batch_size=t.RPN_BATCHSIZE,
            fg_fraction=t.RPN_FG_FRACTION,
            positive_overlap=t.RPN_POSITIVE_OVERLAP,
            negative_overlap=t.RPN_NEGATIVE_OVERLAP,
            clobber_positives=t.RPN_CLOBBER_POSITIVES, generator=generator)
        cls_logits = rpn_out.cls_logits.permute(0, 1, 2, 4, 3)
        cls_logits = cls_logits.reshape(b, -1, 2)         # (y, x, a) order
        rpn_loss_cls = L.masked_cross_entropy(cls_logits, at.labels,
                                              at.labels != -1)
        deltas = rpn_out.bbox_deltas.float().reshape(b, -1, 4)
        rpn_loss_box = L.smooth_l1_loss(
            deltas, at.bbox_targets, at.inside_weights, at.outside_weights,
            sigma=3.0, reduce_dims=(1, 2))

        pt = proposal_targets(
            rois, gt_boxes, rois_per_image=t.BATCH_SIZE,
            fg_fraction=t.FG_FRACTION, fg_thresh=t.FG_THRESH,
            bg_thresh_hi=t.BG_THRESH_HI, bg_thresh_lo=t.BG_THRESH_LO,
            bbox_normalize_means=t.BBOX_NORMALIZE_MEANS,
            bbox_normalize_stds=t.BBOX_NORMALIZE_STDS,
            bbox_inside_weights=t.BBOX_INSIDE_WEIGHTS, generator=generator)
        score, score_prob, bbox_pred = self._head(non_img, non_qry, pt.rois,
                                                  drop)
        labels = pt.labels
        rcnn_loss_cls = L.masked_cross_entropy(
            score.reshape(-1, 2), labels.reshape(-1),
            torch.ones_like(labels.reshape(-1), dtype=torch.bool))
        margin_loss = 3.0 * L.margin_ranking_loss(score_prob, labels,
                                                  t.MARGIN)
        rcnn_loss_bbox = L.smooth_l1_loss(
            bbox_pred, pt.bbox_targets.reshape(-1, 4),
            pt.inside_weights.reshape(-1, 4),
            pt.outside_weights.reshape(-1, 4), sigma=1.0, reduce_dims=(1,))
        r = pt.rois.shape[1]
        return DetectorOut(pt.rois, score_prob.reshape(b, r, 1),
                           bbox_pred.reshape(b, r, -1), rpn_loss_cls,
                           rpn_loss_box, rcnn_loss_cls, margin_loss,
                           rcnn_loss_bbox, labels)

    def _head(self, non_img, non_qry, rois, drop=None):
        """(match logits [B, R, 2] f32, match probability [B, R] f32,
        bbox_pred [B*R, 4] f32); drop: the training forward's dropout."""
        c = self.cfg
        b, num_props = rois.shape[0], rois.shape[1]
        props = roi_align(non_img, rois[..., 1:5], out_size=c.POOLING_SIZE,
                          spatial_scale=1.0 / c.FEAT_STRIDE[0],
                          sampling_ratio=c.tpu.roi_sampling_ratio)
        props = props.reshape((b * num_props,) + props.shape[2:])

        props = self.transformer(props, non_qry, drop)
        props, qfeat = self.sk(props, non_qry)
        props_vec = self.top(props)                       # [B*R, 2048]
        query_vec = self.top(qfeat)                       # [B, 2048]

        bbox_pred = self.bbox_pred_head(props_vec).float()
        d = props_vec.shape[-1]
        props_mat = props_vec.reshape(b, num_props, d)
        query_mat = query_vec[:, None, :].expand(b, num_props, d)
        stack = torch.cat([props_mat, query_mat], dim=-1)
        score = self.cls_score_1(self.cls_score_0(stack)).float()
        return score, torch.softmax(score, dim=-1)[..., 1], bbox_pred

    def head(self, non_img, non_qry, rois) -> DetectorOut:
        """ROI Align -> AIT transformer -> SKNet -> top -> match/box heads,
        from the co-attended features and the proposal layer's rois."""
        b, num_props = rois.shape[0], rois.shape[1]
        _, score_prob, bbox_pred = self._head(non_img, non_qry, rois)
        return DetectorOut(rois, score_prob.reshape(b, num_props, 1),
                           bbox_pred.reshape(b, num_props, -1))
