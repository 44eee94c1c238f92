"""One train step of the port against ait_tpu's at the config's default
model.t_dropout = 0.1, on the tiny flagship (full ResNet-50 widths, TRAIN
tops 64 -> 16, 16 anchors and 8 rois per image), float32 on the CPU, one
numpy-seeded param tree on both sides, for both arrangements of the
decoder's prefix (tpu.dec_prefix_per_image True: the query repeated per
proposal after the first self-attention; False: up front, every proposal
drawing its own prefix masks).

The randomness is injected on both sides.  The sampling uniforms as in
tests/test_torch_train_step.py.  The dropout masks: the test lets JAX trace
the step once to learn the shapes of its `jax.random.bernoulli` calls (the
co-attention's and the transformer's sites, in call order), draws one numpy
keep-mask of Bernoulli(0.9) per call, and hands them to JAX through a
stand-in for `jax.random.bernoulli` and to the port as the `masks` of its
`Dropout`, which the port's sites take in the same order.  Off the TPU both
frameworks then run their plain versions with the same masks (JAX's
`_reference_impl`, `ffn_reference`, `posln_reference`; the port's plain
versions of its kernels).

JAX's gradients come from the single-pass branch of its
`grads_and_metrics` (ait_tpu/train/state.py:102-129) written out here so
that the step's DetectorOut, rois_label included, comes back too; its SGD
step is `ait_tpu.train.make_train_step`'s.

Tolerances: those of tests/test_torch_train_step.py, for the same reasons
(losses 1e-4 relative; every gradient and every SGD delta within 2e-3 of its
leaf's max |JAX value|, 2e-2 in the backbone; rois_label equal), and
2e-2 in the ResNet top (layer4) too: on this batch its first conv's
gradient in the port's float32 differs from the port's own float64 run by
2.1e-3 of the leaf max while that float64 run agrees with JAX to 5e-5 (a
ReLU input within rounding of 0, as in the backbone).
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
from ait_tpu.train.state import batch_tuple
from ait_tpu.train.state import make_train_step as jmake_train_step
from ait_tpu_torch import bridge
from ait_tpu_torch.models import AITDetector as PortDetector
from ait_tpu_torch.models import detector as pdet
from ait_tpu_torch.models.dropout import Dropout
from ait_tpu_torch.train import (lr_schedule, make_optimizer,
                                 make_train_step)
from test_torch_train_step import (BACKBONE_REL, GRAD_REL, LOSS_REL, LOSSES,
                                   KEY_A, KEY_P, T, get, gt_boxes, leaves)

B = 2
KEEP = 0.9


def tolerance(path):
    return BACKBONE_REL if path[0] in ("backbone", "top") else GRAD_REL


def jax_grads_and_out(jmodel, params, batch, rng):
    """(grads, DetectorOut) of ait_tpu's single-pass grads_and_metrics."""
    def loss_fn(p, drop, samp):
        out = jmodel.apply({"params": p}, *batch_tuple(batch), train=True,
                           rngs={"dropout": drop, "sampling": samp})
        return out.total_loss, out

    drop, samp = jax.random.split(rng)
    (_, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params, drop, samp)
    return grads, out


@pytest.fixture(scope="module", params=[True, False],
                ids=["prefix_per_image", "repeat_up_front"])
def run(request):
    jcfg0, _, params, pcfg0, _ = harness.flagship()
    assert jcfg0.model.t_dropout == pytest.approx(1 - KEEP)
    jcfg = jcfg0.replace(tpu=dataclasses.replace(
        jcfg0.tpu, dec_prefix_per_image=request.param))
    pcfg = pcfg0.replace(tpu=dataclasses.replace(
        pcfg0.tpu, dec_prefix_per_image=request.param))
    image, query, info = harness.batch(B)
    gt = gt_boxes(B, jcfg.MAX_NUM_GT_BOXES)
    batch = {"image": image, "query": query, "im_info": info,
             "gt_boxes": gt, "num_boxes": np.ones((B,), np.int32)}
    t = jcfg.TRAIN
    h, w = (-(-n // 16) for n in (harness.H, harness.W))
    n_anchors = h * w * len(jcfg.ANCHOR_SCALES) * len(jcfg.ANCHOR_RATIOS)
    n_p = t.RPN_POST_NMS_TOP_N + jcfg.MAX_NUM_GT_BOXES
    adraws = harness.anchor_draws(KEY_A, B, n_anchors)
    pdraws = harness.proposal_draws(KEY_P, B, n_p, t.BATCH_SIZE)

    jmodel = JaxDetector(jcfg, dtype=jnp.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    mp = pytest.MonkeyPatch()
    real_at, real_pt = jdet.anchor_targets, jdet.proposal_targets
    mp.setattr(jdet, "anchor_targets",
               lambda a, g, i, key, **kw: real_at(a, g, i, KEY_A, **kw))
    mp.setattr(jdet, "proposal_targets",
               lambda r, g, key, **kw: real_pt(r, g, KEY_P, **kw))
    try:
        # the shapes of JAX's dropout draws, in call order
        rec = harness.BernoulliFeed()
        mp.setattr(jax.random, "bernoulli", rec)
        jax.eval_shape(lambda p, b: jax_grads_and_out(
            jmodel, p, b, jax.random.PRNGKey(0)), params, jbatch)
        masks = harness.keep_masks(rec.shapes, KEEP, seed=5)
        mp.setattr(jax.random, "bernoulli", harness.BernoulliFeed(masks))
        grads, jout = jax.jit(lambda p, b: jax_grads_and_out(
            jmodel, p, b, jax.random.PRNGKey(0)))(params, jbatch)
        sched = jlr_schedule(t.LEARNING_RATE, 100, 5, t.GAMMA)
        tx = jmake_optimizer(jcfg, sched)
        state = TrainState.create(params, tx)
        state, _ = jax.jit(jmake_train_step(jmodel, tx))(
            state, jbatch, jax.random.PRNGKey(0))
    finally:
        mp.undo()

    with pytest.MonkeyPatch.context() as mp2:
        mp2.setattr(pdet, "anchor_targets",
                    functools.partial(pdet.anchor_targets, draws=adraws))
        mp2.setattr(pdet, "proposal_targets",
                    functools.partial(pdet.proposal_targets, draws=pdraws))
        mp2.setattr(pdet, "Dropout", lambda rate, generator=None: Dropout(
            rate, generator, masks=masks))
        model = PortDetector(pcfg, dtype=torch.float32)
        model.load_state_dict(bridge.to_state_dict(model, params))
        pbatch = {k: T(v) for k, v in batch.items()}
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
    return dict(params=params, grads=grads, jout=jout, state=state, out=out,
                pgrads=pgrads, pmet=pmet, new=new, shapes=rec.shapes,
                prefix=request.param)


def test_dropout_sites_in_order(run):
    """The co-attention's two attentions (fused at the tiny canvas's 48
    image tokens) draw first, then the transformer's glue, attention and
    FFN sites; without the per-image prefix the decoder's glue and first
    self-attention draw per proposal."""
    r = 8 * B                       # rois in the batch
    rows_dec = (r if not run["prefix"] else B) * 64
    assert run["shapes"] == [
        (8, B * 48, 64), (B * 48, 512), (8, B * 64, 48), (B * 64, 512),
        (r * 56, 512), (8, r * 56, 56), (r * 56, 512), (r * 56, 512),
        (rows_dec, 512), (8, rows_dec, 64), (rows_dec, 512),
        (8, r * 64, 56), (r * 64, 512), (r * 64, 512)]


JAX_LOSS = {"loss": "total_loss", "rpn_cls": "rpn_loss_cls",
            "rpn_box": "rpn_loss_box", "rcnn_cls": "rcnn_loss_cls",
            "margin": "margin_loss", "rcnn_box": "rcnn_loss_bbox"}


@pytest.mark.parametrize("name", [k for k, _ in LOSSES])
def test_losses_match(run, name):
    want = float(getattr(run["jout"], JAX_LOSS[name]))
    got = float(run["pmet"][name])
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=LOSS_REL, atol=1e-6)


def test_rois_label_and_counts_equal(run):
    want = np.asarray(run["jout"].rois_label)
    np.testing.assert_array_equal(run["out"].rois_label.numpy(), want)
    pm = run["pmet"]
    assert int(pm["fg_cnt"]) == int((want != 0).sum())
    assert int(pm["bg_cnt"]) == int((want == 0).sum())


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
            if not np.array_equal(got, np.zeros_like(got)):
                bad.append(("/".join(path), "frozen leaf moved"))
            continue
        err = float(np.abs(got - want).max())
        if err > tolerance(path) * scale:
            bad.append(("/".join(path), err, scale))
    assert not bad, bad[:10]

