"""The port's whole eval slice against ait_tpu's: the tiny flagship (full
ResNet-50 widths, TEST tops 32 -> 8) on a 96x128 uint8 canvas with 128x128
queries, float32 on the CPU, one numpy-seeded param tree on both sides.

Whole forward: rois within 1e-2 px (the box decode's exp differs from XLA's
in the last ulp and the backbone sums in another order), cls_prob within
1e-5 and bbox_pred within 1e-4 (measured: 2e-7 and 3e-5).  Staged, so that
a near-tie in top-k or NMS can neither hide a fault nor fake one: JAX's
decoded proposals through the port's top-k + NMS give bit-identical rois,
and JAX's rois and features through the port's head give JAX's scores.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_harness as harness
from ait_tpu.evaluation.postprocess import postprocess_detections as jpost
from ait_tpu.models.detector import _to_model_input
from ait_tpu.models.rpn import proposal_layer as jproposal_layer
from ait_tpu.ops.anchors import shifted_anchors
from ait_tpu.ops.boxes import bbox_transform_inv, clip_boxes
from ait_tpu.ops.nms import batched_nms_topk as jax_nms_topk
from ait_tpu_torch.models.rpn import RPNOut, proposal_layer
from ait_tpu_torch.ops.nms import batched_nms_topk
from ait_tpu_torch.predict import OneShotPredictor


def T(a):
    return torch.from_numpy(np.array(a))


def _stages(m, image, query):
    img = m.backbone(_to_model_input(image, m.dtype))
    qry = m.backbone(_to_model_input(query, m.dtype))
    non_img, non_qry = m.coattention(img, qry, deterministic=True)
    return non_img, non_qry, m.rpn(non_img)


@pytest.fixture(scope="module")
def run():
    cfg, jm, params, pcfg, pm = harness.flagship()
    image, query, info = harness.batch(2)
    b = image.shape[0]
    gt = jnp.zeros((b, cfg.MAX_NUM_GT_BOXES, 5))
    nb = jnp.zeros((b,), jnp.int32)
    jout = jax.jit(lambda p, i, q, ii: jm.apply(
        {"params": p}, i, q, ii, gt, nb, train=False))(params, image, query,
                                                        info)
    non_img, non_qry, rpn_out = jax.jit(lambda p, i, q: jm.apply(
        {"params": p}, i, q, method=_stages))(params, image, query)
    with torch.inference_mode():
        pout = pm(T(image), T(query), T(info))
    return dict(cfg=cfg, pcfg=pcfg, pm=pm, image=image, query=query,
                info=info, jout=jout, pout=pout, non_img=non_img,
                non_qry=non_qry, rpn_out=rpn_out)


def test_eval_forward_matches(run):
    jout, pout = run["jout"], run["pout"]
    for name, atol in (("rois", 1e-2), ("cls_prob", 1e-5),
                       ("bbox_pred", 1e-4)):
        want = np.asarray(getattr(jout, name))
        got = getattr(pout, name).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                   err_msg=name)


def test_predictor_matches_postprocessed_jax(run):
    """OneShotPredictor (device='cpu') end to end vs JAX's eval forward +
    postprocess_detections."""
    cfg, pcfg, jout = run["cfg"], run["pcfg"], run["jout"]
    pred = OneShotPredictor(pcfg, run["pm"].state_dict(), device="cpu",
                            dtype=torch.float32)
    got = pred.predict_prepared(run["image"], run["query"], run["info"])
    t = cfg.TEST
    dets, valid = jpost(jout.rois, jout.cls_prob, jout.bbox_pred,
                        jnp.asarray(run["info"]), nms_thresh=t.NMS,
                        max_per_image=t.MAX_PER_IMAGE,
                        bbox_normalize_means=cfg.TRAIN.BBOX_NORMALIZE_MEANS,
                        bbox_normalize_stds=cfg.TRAIN.BBOX_NORMALIZE_STDS)
    dets, valid = np.asarray(dets), np.asarray(valid)
    assert len(got) == len(dets)
    for g, d, v in zip(got, dets, valid):
        assert g.shape == (int(v.sum()), 5)
        np.testing.assert_allclose(g, d[v], rtol=0, atol=1e-2)


def _jax_proposals(run):
    """The proposal layer's decoded boxes, scores and validity, as the JAX
    package computes them before its top-k + NMS."""
    rpn = run["rpn_out"]
    b, h, w, _, a = rpn.cls_logits.shape
    anchors = shifted_anchors(h, w, 16)
    info = jnp.asarray(run["info"])
    scores = jax.nn.softmax(rpn.cls_logits, axis=3)[..., 1, :]
    scores = scores.reshape(b, h * w * a)
    deltas = rpn.bbox_deltas.reshape(b, h * w * a, 4)
    boxes = clip_boxes(bbox_transform_inv(anchors[None], deltas),
                       info[:, None, :2])
    cx = 0.5 * (anchors[:, 0] + anchors[:, 2])
    cy = 0.5 * (anchors[:, 1] + anchors[:, 3])
    inside = (cx[None] < info[:, None, 1]) & (cy[None] < info[:, None, 0])
    return boxes, scores, inside


def test_staged_nms_bit_identical(run):
    t = run["cfg"].TEST
    boxes, scores, inside = _jax_proposals(run)
    want = jax_nms_topk(boxes, scores, t.RPN_NMS_THRESH, t.RPN_PRE_NMS_TOP_N,
                        t.RPN_POST_NMS_TOP_N, valid=inside)
    got = batched_nms_topk(T(boxes), T(scores), t.RPN_NMS_THRESH,
                           t.RPN_PRE_NMS_TOP_N, t.RPN_POST_NMS_TOP_N,
                           valid=T(inside))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_staged_proposal_layer_on_jax_rpn_outputs(run):
    t = run["cfg"].TEST
    rpn = run["rpn_out"]
    h, w = rpn.cls_logits.shape[1:3]
    anchors = shifted_anchors(h, w, 16)
    want = jproposal_layer(rpn, anchors, jnp.asarray(run["info"]),
                           pre_nms_topk=t.RPN_PRE_NMS_TOP_N,
                           post_nms_topk=t.RPN_POST_NMS_TOP_N,
                           nms_thresh=t.RPN_NMS_THRESH)
    got = proposal_layer(RPNOut(T(rpn.cls_logits), T(rpn.bbox_deltas)),
                         T(anchors), T(run["info"]),
                         pre_nms_topk=t.RPN_PRE_NMS_TOP_N,
                         post_nms_topk=t.RPN_POST_NMS_TOP_N,
                         nms_thresh=t.RPN_NMS_THRESH)
    # the same selection; coordinates within the exp's last-ulp difference
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-3)


def test_staged_head_on_jax_rois(run):
    """JAX's co-attended features and rois through the port's head
    (ROI Align -> transformer -> SKNet -> top -> heads)."""
    jout = run["jout"]
    with torch.inference_mode():
        got = run["pm"].head(T(run["non_img"]), T(run["non_qry"]),
                             T(jout.rois))
    np.testing.assert_allclose(got.cls_prob.numpy(),
                               np.asarray(jout.cls_prob), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.bbox_pred.numpy(),
                               np.asarray(jout.bbox_pred), rtol=0, atol=1e-4)
