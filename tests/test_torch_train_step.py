"""One train step of the port against ait_tpu's, on the tiny flagship (full
ResNet-50 widths, TRAIN tops 64 -> 16, 16 anchors and 8 rois per image)
with model.t_dropout = 0, on a 96x128 uint8 canvas with 128x128 queries,
float32 on the CPU, one numpy-seeded param tree on both sides.

The sampling draws are injected: the test wraps `anchor_targets` and
`proposal_targets` in ait_tpu.models.detector's namespace so that JAX draws
from keys the test chose, derives the same uniforms from those keys (with
the split sequence of ait_tpu/models/targets.py:80-84,145,151) and hands
them to the port's targets.

Tolerances, with their reasons:
* losses within 1e-4 relative: the two frameworks sum in other orders
  through a full-width ResNet-50 (the eval slice agrees to ~1e-6);
* rois_label, fg/bg counts equal; rois within 1e-2 px (box decode's exp
  differs from XLA's in the last ulp, see tests/test_torch_port_slice.py);
* every parameter gradient within 2e-3 of its leaf's max |JAX gradient|,
  and every parameter delta of the SGD step within 2e-3 of its leaf's max
  |JAX delta|: f32 gradients of the same graph through ~100 layers, where
  reassociated sums differ by ~1e-6 relative per layer (measured: <= 3e-4
  outside the backbone);
* in the backbone, 2e-2 of the leaf max: a ReLU whose f32 input lies within
  rounding of 0 can take the other branch in one framework.  On this batch
  one pre-activation of layer2 (-1.2e-6 in the port's f32, positive in its
  float64 run, and JAX agrees with float64) does so, and the convolutions
  of layer1 and layer2 then differ by up to 1e-2 of their leaf max; the
  float64 run agrees with JAX to 2e-5 everywhere.
The staged check runs JAX's own rois (and co-attended features) through
the port's proposal_targets and head, so that a near-tie in NMS can
neither hide a fault nor fake one.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_harness as harness
from ait_tpu.models import detector as jdet
from ait_tpu.models.detector import AITDetector as JaxDetector
from ait_tpu.train import TrainState
from ait_tpu.train import lr_schedule as jlr_schedule
from ait_tpu.train import make_optimizer as jmake_optimizer
from ait_tpu.train.state import grads_and_metrics as jgrads_and_metrics
from ait_tpu.train.state import make_train_step as jmake_train_step
from ait_tpu_torch import bridge
from ait_tpu_torch.models import AITDetector as PortDetector
from ait_tpu_torch.models import detector as pdet
from ait_tpu_torch.models.targets import proposal_targets
from ait_tpu_torch.train import (lr_schedule, make_optimizer,
                                 make_train_step)

KEY_A, KEY_P = jax.random.PRNGKey(11), jax.random.PRNGKey(12)
B = 2
GRAD_REL = 2e-3
BACKBONE_REL = 2e-2
LOSS_REL = 1e-4


def tolerance(path):
    return BACKBONE_REL if path[0] == "backbone" else GRAD_REL


def T(a):
    return torch.from_numpy(np.array(a))


def gt_boxes(b, g):
    gt = np.zeros((b, g, 5), np.float32)
    gt[:, 0] = [8, 8, 60, 60, 1]
    gt[1, 1] = [30, 20, 100, 80, 1]
    return gt


def leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def get(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


@pytest.fixture(scope="module")
def run():
    jcfg0, _, params, pcfg0, _ = harness.flagship()
    jcfg = jcfg0.replace(model=dataclasses.replace(jcfg0.model,
                                                   t_dropout=0.0))
    pcfg = pcfg0.replace(model=dataclasses.replace(pcfg0.model,
                                                   t_dropout=0.0))
    image, query, info = harness.batch(B)
    gt = gt_boxes(B, jcfg.MAX_NUM_GT_BOXES)
    batch = {"image": image, "query": query, "im_info": info,
             "gt_boxes": gt, "num_boxes": np.ones((B,), np.int32)}
    t = jcfg.TRAIN
    h, w = (-(-H // 16) for H in (harness.H, harness.W))
    n_anchors = h * w * len(jcfg.ANCHOR_SCALES) * len(jcfg.ANCHOR_RATIOS)
    n_p = t.RPN_POST_NMS_TOP_N + jcfg.MAX_NUM_GT_BOXES
    adraws = harness.anchor_draws(KEY_A, B, n_anchors)
    pdraws = harness.proposal_draws(KEY_P, B, n_p, t.BATCH_SIZE)

    # JAX: its targets on the keys the test chose
    mp = pytest.MonkeyPatch()
    real_at, real_pt = jdet.anchor_targets, jdet.proposal_targets
    mp.setattr(jdet, "anchor_targets",
               lambda a, g, i, key, **kw: real_at(a, g, i, KEY_A, **kw))
    mp.setattr(jdet, "proposal_targets",
               lambda r, g, key, **kw: real_pt(r, g, KEY_P, **kw))
    try:
        jmodel = JaxDetector(jcfg, dtype=jnp.float32)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        grads, jmet = jax.jit(lambda p, b: jgrads_and_metrics(
            jmodel, p, b, jax.random.PRNGKey(0)))(params, jbatch)
        sched = jlr_schedule(t.LEARNING_RATE, 100, 5, t.GAMMA)
        tx = jmake_optimizer(jcfg, sched)
        state = TrainState.create(params, tx)
        state, _ = jax.jit(jmake_train_step(jmodel, tx))(
            state, jbatch, jax.random.PRNGKey(0))
        jout = jax.jit(lambda p, b: jmodel.apply(
            {"params": p}, *(b[k] for k in ("image", "query", "im_info",
                                             "gt_boxes", "num_boxes")),
            train=True, rngs={"dropout": jax.random.PRNGKey(1),
                              "sampling": jax.random.PRNGKey(2)},
            method=_train_stages))(params, jbatch)
    finally:
        mp.undo()

    # the port: the same uniforms
    with pytest.MonkeyPatch.context() as mp2:
        mp2.setattr(pdet, "anchor_targets",
                    functools.partial(pdet.anchor_targets, draws=adraws))
        mp2.setattr(pdet, "proposal_targets",
                    functools.partial(pdet.proposal_targets, draws=pdraws))
        model = PortDetector(pcfg, dtype=torch.float32)
        model.load_state_dict(bridge.to_state_dict(model, params))
        pbatch = {k: T(v) for k, v in batch.items()}
        staged = _port_staged(model, pcfg, jout, pbatch, pdraws)
        out = model(*(pbatch[k] for k in ("image", "query", "im_info",
                                          "gt_boxes", "num_boxes")),
                    train=True, generator=torch.Generator())
        out.total_loss.backward()
        pgrads = bridge.grad_tree(model)
        model.zero_grad(set_to_none=True)
        opt = make_optimizer(pcfg, model)
        step = make_train_step(model, opt, lr_schedule(
            t.LEARNING_RATE, 100, 5, t.GAMMA), device="cpu")
        pmet = step(pbatch, torch.Generator())
        new = bridge.to_jax_tree(model, model.state_dict())
    return dict(params=params, grads=grads, jmet=jmet, state=state,
                out=out, pgrads=pgrads, pmet=pmet, new=new, jout=jout,
                staged=staged)


def _port_staged(model, pcfg, jout, pbatch, pdraws):
    """JAX's rois through the port's proposal_targets, and JAX's features
    with the sampled rois through the port's head (the weights before the
    step)."""
    non_img, non_qry, rois, _, _, _ = jout
    c = pcfg.TRAIN
    pt = proposal_targets(
        T(rois), pbatch["gt_boxes"], rois_per_image=c.BATCH_SIZE,
        fg_fraction=c.FG_FRACTION, fg_thresh=c.FG_THRESH,
        bg_thresh_hi=c.BG_THRESH_HI, bg_thresh_lo=c.BG_THRESH_LO,
        bbox_normalize_means=c.BBOX_NORMALIZE_MEANS,
        bbox_normalize_stds=c.BBOX_NORMALIZE_STDS,
        bbox_inside_weights=c.BBOX_INSIDE_WEIGHTS, draws=pdraws)
    with torch.no_grad():
        score, _, bbox = model._head(T(non_img), T(non_qry), pt.rois)
    return pt, score, bbox


def _train_stages(m, image, query, im_info, gt_boxes, num_boxes, train):
    """JAX's co-attended features and rois on the train tops."""
    c = m.cfg
    img = m.backbone(jdet._to_model_input(image, m.dtype))
    qry = m.backbone(jdet._to_model_input(query, m.dtype))
    non_img, non_qry = m.coattention(img, qry, deterministic=not train)
    rpn_out = m.rpn(non_img)
    fh, fw = non_img.shape[1], non_img.shape[2]
    anchors = jdet.shifted_anchors(fh, fw, c.FEAT_STRIDE[0],
                                   ratios=c.ANCHOR_RATIOS,
                                   scales=c.ANCHOR_SCALES)
    rois = jdet.proposal_layer(
        rpn_out, anchors, im_info, pre_nms_topk=c.TRAIN.RPN_PRE_NMS_TOP_N,
        post_nms_topk=c.TRAIN.RPN_POST_NMS_TOP_N,
        nms_thresh=c.TRAIN.RPN_NMS_THRESH)
    pt = jdet.proposal_targets(
        rois, gt_boxes, KEY_P, rois_per_image=c.TRAIN.BATCH_SIZE,
        fg_fraction=c.TRAIN.FG_FRACTION, fg_thresh=c.TRAIN.FG_THRESH,
        bg_thresh_hi=c.TRAIN.BG_THRESH_HI, bg_thresh_lo=c.TRAIN.BG_THRESH_LO,
        bbox_normalize_means=c.TRAIN.BBOX_NORMALIZE_MEANS,
        bbox_normalize_stds=c.TRAIN.BBOX_NORMALIZE_STDS,
        bbox_inside_weights=c.TRAIN.BBOX_INSIDE_WEIGHTS)
    b, r = pt.rois.shape[:2]
    props = jdet.roi_align(non_img, pt.rois[..., 1:5],
                           out_size=c.POOLING_SIZE,
                           spatial_scale=1.0 / c.FEAT_STRIDE[0],
                           sampling_ratio=c.tpu.roi_sampling_ratio)
    props = props.reshape((b * r,) + props.shape[2:])
    props = m.transformer(props, non_qry, deterministic=not train)
    props, qfeat = m.sk(props, non_qry)
    pv, qv = m.top(props), m.top(qfeat)
    bbox = m.bbox_pred_head(pv).astype(jnp.float32)
    d = pv.shape[-1]
    stack = jnp.concatenate([pv.reshape(b, r, d), jnp.broadcast_to(
        qv[:, None, :], (b, r, d))], axis=-1)
    score = m.cls_score_1(m.cls_score_0(stack)).astype(jnp.float32)
    return non_img, non_qry, rois, pt, score, bbox


LOSSES = [("loss", "loss"), ("rpn_cls", "rpn_cls"), ("rpn_box", "rpn_box"),
          ("rcnn_cls", "rcnn_cls"), ("margin", "margin"),
          ("rcnn_box", "rcnn_box")]


@pytest.mark.parametrize("name", [k for k, _ in LOSSES])
def test_losses_match(run, name):
    want = float(run["jmet"][name])
    got = float(run["pmet"][name])
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=LOSS_REL, atol=1e-6)


def test_targets_and_counts_equal(run):
    jm, pm = run["jmet"], run["pmet"]
    assert int(pm["fg_cnt"]) == int(jm["fg_cnt"])
    assert int(pm["bg_cnt"]) == int(jm["bg_cnt"])
    pt = run["jout"][3]
    np.testing.assert_array_equal(run["out"].rois_label.numpy(),
                                  np.asarray(pt.labels))
    np.testing.assert_allclose(run["out"].rois.detach().numpy(),
                               np.asarray(pt.rois), rtol=0, atol=1e-2)


def test_every_gradient_matches(run):
    bad = []
    for path, want in leaves(run["grads"]):
        got = get(run["pgrads"], path)
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        if err > tolerance(path) * max(scale, 1e-12):
            bad.append(("/".join(path), err, scale))
    assert not bad, bad[:10]


def test_every_parameter_delta_matches(run):
    bad = []
    for path, old in leaves(run["params"]):
        want = get(run["state"].params, path) - old
        got = get(run["new"], path) - old
        scale = float(np.abs(want).max())
        if scale == 0.0:
            # frozen leaves (stem conv, FrozenBN): bitwise unchanged
            if not np.array_equal(got, np.zeros_like(got)):
                bad.append(("/".join(path), "frozen leaf moved"))
            continue
        err = float(np.abs(got - want).max())
        if err > tolerance(path) * scale:
            bad.append(("/".join(path), err, scale))
    assert not bad, bad[:10]


def test_staged_targets_and_head_on_jax_rois(run):
    """JAX's rois through the port's proposal_targets: equal labels and
    rois, bbox targets to f32 rounding; JAX's features and sampled rois
    through the port's head: JAX's match logits and box deltas."""
    _, _, _, pt, score, bbox = run["jout"]
    got, pscore, pbbox = run["staged"]
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(pt.labels))
    np.testing.assert_array_equal(got.rois.numpy(), np.asarray(pt.rois))
    np.testing.assert_allclose(got.bbox_targets.numpy(),
                               np.asarray(pt.bbox_targets), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(pscore.numpy(), np.asarray(score), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(pbbox.numpy(), np.asarray(bbox), rtol=0,
                               atol=1e-4)
