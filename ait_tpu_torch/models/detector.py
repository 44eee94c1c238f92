"""The one-shot detector (counterpart of ait_tpu/models/detector.py::
AITDetector).

Siamese backbone (ResNet, or VGG16 with `model.backbone` "vgg16") ->
co-attention (MHA, the VOC flavor, or the COCO non-local one with
`model.coattention` "nonlocal") -> RPN -> proposal layer (NMS kernel) ->
ROI Align (or ROI pool, `POOLING_MODE` "pool") -> AIT transformer
(attention, FFN and glue kernels) -> SKNet -> top (ResNet layer4, or
VGG16's fc6/fc7, 4096 wide) -> match and box heads.  With
`model.with_contextual_relation` (ResNet only) the query's stage features
give a per-channel gate (`ContextualRelation`) that scales both head
vectors.

Inputs are NHWC: image [B, H, W, 3] (a padded canvas, true extent in
im_info) or, as the loader ships it with `tpu.host_s2d`, its space-to-depth
form [B, H/2, W/2, 12]; query [B, 128, 128, 3]; both uint8 RGB or already
normalized floats; im_info [B, 3] = (h, w, scale); in training gt_boxes
[B, G, 5] (zero-padded, binary class in column 4).  Returns a DetectorOut:
rois [B, R, 5], cls_prob [B, R, 1], bbox_pred [B, R, 4] (8 with
model.class_agnostic False, eval only, as in the JAX package) and, in
training, the five losses and rois_label.

Training takes the TRAIN tops of the proposal layer, samples anchor and
proposal targets with the caller's `torch.Generator` (models/targets.py),
and runs the transformer's kernels through their autograd Functions.
Dropout at model.t_dropout (the co-attention's two attentions, and every
glue, attention and FFN of the transformer, inside their kernels) draws from
the same generator: one `Dropout` (models/dropout.py) goes down the forward,
and the sites draw their seeds from it in call order (co-attention, then,
after the target sampling, the transformer, then VGG16's top, whose two
dropouts run at 0.5 in training whatever model.t_dropout is).  Eval draws
nothing.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ait_tpu_torch.config import Config
from ait_tpu_torch.models import losses as L
from ait_tpu_torch.models.ait_transformer import AITTransformer
from ait_tpu_torch.models.coattention import (MHACoAttention,
                                              NonLocalCoAttention)
from ait_tpu_torch.models.dropout import Dropout
from ait_tpu_torch.models.layers import Dense
from ait_tpu_torch.models.resnet import (STAGES, ContextualRelation,
                                         ResNetBackbone, ResNetTop)
from ait_tpu_torch.models.rpn import RPNHead, proposal_layer
from ait_tpu_torch.models.sknet import SKNet
from ait_tpu_torch.models.targets import anchor_targets, proposal_targets
from ait_tpu_torch.models.vgg import VGGBackbone, VGGTop
from ait_tpu_torch.ops.anchors import shifted_anchors
from ait_tpu_torch.ops.roi_align import roi_align
from ait_tpu_torch.ops.roi_pool import roi_pool

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
    """The model paths the port refuses: the parallel families (ROADMAP
    A15), and values no detector takes."""
    parallel = [k for k in ("tp_size", "sp_size")
                if getattr(cfg.tpu, k) > 1]
    if parallel:
        raise NotImplementedError(
            f"tpu.{', tpu.'.join(parallel)} > 1: the parallel families "
            "(tensor and sequence parallelism) are not ported yet (ROADMAP "
            "A15)")
    mc = cfg.model
    if mc.backbone not in STAGES and mc.backbone != "vgg16":
        raise ValueError(f"model.backbone {mc.backbone}")
    if mc.coattention not in ("mha", "nonlocal"):
        raise ValueError(f"model.coattention {mc.coattention}")
    if cfg.POOLING_MODE not in ("align", "pool"):
        raise ValueError(f"POOLING_MODE {cfg.POOLING_MODE}")
    if mc.with_contextual_relation and mc.backbone not in STAGES:
        raise ValueError("the contextual relation needs stage taps: ResNet "
                         "backbones only (as the reference)")


class AITDetector(nn.Module):
    def __init__(self, cfg: Config, dtype=torch.float32):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.dtype = dtype
        mc = cfg.model
        ch = mc.channels
        if mc.backbone == "vgg16":
            self.backbone = VGGBackbone(dtype=dtype)
            # fc6 flattens the transformer's output, the query's feature
            # grid (query_size / 16 a side) at `channels`
            side = cfg.TRAIN.query_size // cfg.FEAT_STRIDE[0]
            self.top = VGGTop(side * side * ch, dtype=dtype)
            top_dim = 4096
        else:
            self.backbone = ResNetBackbone(mc.backbone, dtype=dtype)
            self.top = ResNetTop(mc.backbone, dtype=dtype)
            top_dim = 2048
        if mc.coattention == "nonlocal":
            self.coattention = NonLocalCoAttention(
                ch, mc.coatt_normalization, dtype=dtype)
        else:
            self.coattention = MHACoAttention(ch, mc.t_n_head, mc.t_d_k,
                                              mc.t_d_v, dtype=dtype)
        self.rpn = RPNHead(ch, len(cfg.ANCHOR_SCALES) *
                           len(cfg.ANCHOR_RATIOS), dtype=dtype)
        self.transformer = AITTransformer(
            d_model=mc.t_d_model, d_inner=mc.t_d_inner,
            n_layers=mc.t_n_layers, n_head=mc.t_n_head, d_k=mc.t_d_k,
            d_v=mc.t_d_v, n_position=mc.t_n_position,
            causal_mask=mc.t_causal_mask, dist=mc.t_attn_dist, channels=ch,
            dec_prefix_per_image=cfg.tpu.dec_prefix_per_image, dtype=dtype)
        self.sk = SKNet(ch, gate=mc.sk_gate, dtype=dtype)
        if mc.with_contextual_relation:
            self.contextual = ContextualRelation(
                channels=2048, reduction=mc.rnn_reduction,
                rnn_layers=mc.rnn_layers, bidirectional=mc.rnn_bidirectional,
                method=mc.rnn_method, dtype=dtype)
        # the heads take the top's width: 2048 (ResNet), 4096 (VGG16)
        self.cls_score_0 = Dense(2 * top_dim, 8, dtype=dtype)
        self.cls_score_1 = Dense(8, 2, dtype=dtype)
        # class-specific regression: a box for background and foreground
        self.bbox_pred_head = Dense(top_dim, 4 if mc.class_agnostic else 8,
                                    dtype=dtype)

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
            if not c.model.class_agnostic:
                # ait_tpu's box loss takes 4 columns and fails on 8
                # (ait_tpu/models/detector.py:280-282)
                raise NotImplementedError(
                    "training needs model.class_agnostic=True: the box loss "
                    "takes 4 columns, the class-specific head gives 8")
            drop = Dropout(c.model.t_dropout, generator)
        image_feat = self.backbone(_to_model_input(image, self.dtype))
        if pair_image_idx is not None:
            image_feat = image_feat[pair_image_idx]
        query_scale = None
        if c.model.with_contextual_relation:
            query_feat, stages = self.backbone(
                _to_model_input(query, self.dtype), return_stages=True)
            query_scale = self.contextual(stages)        # [B, 2048] f32
        else:
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
            return self.head(non_img, non_qry, rois, query_scale)

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
                                                  query_scale, drop)
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

    def _head(self, non_img, non_qry, rois, query_scale=None, drop=None):
        """(match logits [B, R, 2] f32, match probability [B, R] f32,
        bbox_pred [B*R, 4 or 8] f32); query_scale: the contextual gate
        [B, 2048] f32 or None; drop: the training forward's dropout."""
        c = self.cfg
        b, num_props = rois.shape[0], rois.shape[1]
        if c.POOLING_MODE == "pool":
            props = roi_pool(non_img, rois[..., 1:5], out_size=c.POOLING_SIZE,
                             spatial_scale=1.0 / c.FEAT_STRIDE[0])
        else:
            props = roi_align(non_img, rois[..., 1:5],
                              out_size=c.POOLING_SIZE,
                              spatial_scale=1.0 / c.FEAT_STRIDE[0],
                              sampling_ratio=c.tpu.roi_sampling_ratio)
        props = props.reshape((b * num_props,) + props.shape[2:])

        props = self.transformer(props, non_qry, drop)
        props, qfeat = self.sk(props, non_qry)
        if isinstance(self.top, VGGTop):
            props_vec = self.top(props, drop)             # [B*R, 4096]
            query_vec = self.top(qfeat, drop)             # [B, 4096]
        else:
            props_vec = self.top(props)                   # [B*R, 2048]
            query_vec = self.top(qfeat)                   # [B, 2048]
        if query_scale is not None:
            # both streams scaled by the query's gate (detector.py:253-260)
            s = query_scale.to(props_vec.dtype)
            props_vec = (props_vec.reshape(b, num_props, -1) *
                         s[:, None, :]).reshape(props_vec.shape)
            query_vec = query_vec * s

        bbox_pred = self.bbox_pred_head(props_vec).float()
        d = props_vec.shape[-1]
        props_mat = props_vec.reshape(b, num_props, d)
        query_mat = query_vec[:, None, :].expand(b, num_props, d)
        stack = torch.cat([props_mat, query_mat], dim=-1)
        score = self.cls_score_1(self.cls_score_0(stack)).float()
        return score, torch.softmax(score, dim=-1)[..., 1], bbox_pred

    def head(self, non_img, non_qry, rois, query_scale=None) -> DetectorOut:
        """ROI Align (or pool) -> AIT transformer -> SKNet -> top ->
        match/box heads, from the co-attended features, the proposal
        layer's rois and, with the contextual relation, the query's gate."""
        b, num_props = rois.shape[0], rois.shape[1]
        _, score_prob, bbox_pred = self._head(non_img, non_qry, rois,
                                              query_scale)
        return DetectorOut(rois, score_prob.reshape(b, num_props, 1),
                           bbox_pred.reshape(b, num_props, -1))
