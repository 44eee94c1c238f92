"""Gradient accumulation and the shot-fused eval step of the port against
ait_tpu's, on the tiny flagship, float32 on the CPU, one numpy-seeded param
tree on both sides.

Accumulation (`grads_and_metrics(..., accum_steps=2)`, model.t_dropout 0):
the batch of 2 runs as 2 microbatches of 1 in order; gradients are the mean,
loss metrics the mean, fg_cnt / bg_cnt the sum.  JAX runs its microbatches
under `lax.scan`, which traces the body once, so the test gives both
microbatches the same sampling keys (the targets wrapped as in
tests/test_torch_train_step.py) and hands the port the uniforms of those
keys for each microbatch.  Tolerances are that file's, with the ResNet top
(layer4) at the backbone's 2e-2 as in tests/test_torch_dropout_step.py and
for its reason (a ReLU input within rounding of 0 takes the other branch in
one framework; measured here 1.3e-2 on layer4's first block, every other
leaf within 2e-3).  That the port draws
microbatch after microbatch from its one generator (its counterpart of
`fold_in(rng, i)`), dropout included, is checked inside the port: a step of
accum_steps 2 equals the mean of two single-pass calls on the halves that
continue one generator.

The fused eval step (`make_fused_eval_step`): U = 2 images with A = 2 query
shots each equals `make_eval_step` on the expanded pair batch, and ait_tpu's
`make_fused_eval_step`, at tests/test_torch_port_slice.py's tolerances.
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
from ait_tpu.train.optim import param_label as jparam_label
from ait_tpu.train.state import grads_and_metrics as jgrads_and_metrics
from ait_tpu.train.state import make_fused_eval_step as jmake_fused_eval_step
from ait_tpu_torch import bridge
from ait_tpu_torch.models import AITDetector as PortDetector
from ait_tpu_torch.models import detector as pdet
from ait_tpu_torch.train import (grads_and_metrics, make_eval_step,
                                 make_fused_eval_step)
from test_torch_dropout_step import tolerance
from test_torch_train_step import (KEY_A, KEY_P, LOSS_REL, T, get, gt_boxes,
                                   leaves)

B, A = 2, 2
LOSSES = ("loss", "rpn_cls", "rpn_box", "rcnn_cls", "margin", "rcnn_box")


def train_batch(cfg):
    image, query, info = harness.batch(B)
    return {"image": image, "query": query, "im_info": info,
            "gt_boxes": gt_boxes(B, cfg.MAX_NUM_GT_BOXES),
            "num_boxes": np.ones((B,), np.int32)}


@pytest.fixture(scope="module")
def accum():
    jcfg0, _, params, pcfg0, _ = harness.flagship()
    jcfg = jcfg0.replace(model=dataclasses.replace(jcfg0.model,
                                                   t_dropout=0.0))
    pcfg = pcfg0.replace(model=dataclasses.replace(pcfg0.model,
                                                   t_dropout=0.0))
    batch = train_batch(jcfg)
    t = jcfg.TRAIN
    h, w = (-(-n // 16) for n in (harness.H, harness.W))
    n_anchors = h * w * len(jcfg.ANCHOR_SCALES) * len(jcfg.ANCHOR_RATIOS)
    n_p = t.RPN_POST_NMS_TOP_N + jcfg.MAX_NUM_GT_BOXES
    micro = B // A
    adraws = harness.anchor_draws(KEY_A, micro, n_anchors)
    pdraws = harness.proposal_draws(KEY_P, micro, n_p, t.BATCH_SIZE)

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
            jmodel, p, b, jax.random.PRNGKey(0), accum_steps=A))(params,
                                                                 jbatch)
    finally:
        mp.undo()

    with pytest.MonkeyPatch.context() as mp2:
        mp2.setattr(pdet, "anchor_targets",
                    functools.partial(pdet.anchor_targets, draws=adraws))
        mp2.setattr(pdet, "proposal_targets",
                    functools.partial(pdet.proposal_targets, draws=pdraws))
        model = PortDetector(pcfg, dtype=torch.float32)
        model.load_state_dict(bridge.to_state_dict(model, params))
        model.train()
        pmet = grads_and_metrics(model, {k: T(v) for k, v in batch.items()},
                                 torch.Generator(), accum_steps=A)
        pgrads = bridge.grad_tree(model)
    return dict(grads=grads, jmet=jmet, pmet=pmet, pgrads=pgrads)


@pytest.mark.parametrize("name", LOSSES)
def test_accumulated_losses_are_the_mean(accum, name):
    got, want = float(accum["pmet"][name]), float(accum["jmet"][name])
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=LOSS_REL, atol=1e-6)


def test_accumulated_counts_are_the_sum(accum):
    pm, jm = accum["pmet"], accum["jmet"]
    for k in ("fg_cnt", "bg_cnt"):
        assert pm[k].dtype == torch.float32
        assert float(pm[k]) == float(jm[k]), k
    assert float(pm["fg_cnt"]) + float(pm["bg_cnt"]) == B * 8   # 8 rois each


def test_accumulated_gradients_are_the_mean(accum):
    bad = []
    for path, want in leaves(accum["grads"]):
        got = get(accum["pgrads"], path)
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        if err > tolerance(path) * max(scale, 1e-12):
            bad.append(("/".join(path), err, scale))
    assert not bad, bad[:10]


def test_frozen_leaves_have_zero_gradients_in_jax(accum):
    """What lets the port clip on the trainable leaves' norm alone: the
    frozen leaves' gradients are exact zeros in ait_tpu (stop_gradient), so
    optax's whole-tree norm is the same number."""
    frozen = [(p, g) for p, g in leaves(accum["grads"])
              if jparam_label(p) == "frozen"]
    assert len(frozen) > 100
    for path, g in frozen:
        assert not np.asarray(g).any(), path


def test_accumulation_equals_the_mean_of_its_microbatches():
    """With dropout on (t_dropout 0.1): accum_steps 2 on the batch equals the
    mean of two single-pass calls on its halves that continue one generator
    (sampling and dropout seeds drawn microbatch after microbatch)."""
    _, _, params, pcfg, _ = harness.flagship()
    batch = {k: T(v) for k, v in train_batch(pcfg).items()}

    def fresh():
        m = PortDetector(pcfg, dtype=torch.float32)
        m.load_state_dict(bridge.to_state_dict(m, params))
        return m.train()

    model = fresh()
    met = grads_and_metrics(model, batch, torch.Generator().manual_seed(3),
                            accum_steps=2)
    got = {k: p.grad.clone() for k, p in model.named_parameters()
           if p.grad is not None}

    gen = torch.Generator().manual_seed(3)
    halves, mets = [], []
    for i in range(2):
        m = fresh()
        mets.append(grads_and_metrics(
            m, {k: v[i:i + 1] for k, v in batch.items()}, gen))
        halves.append({k: p.grad for k, p in m.named_parameters()
                       if p.grad is not None})
    assert sorted(got) == sorted(halves[0]) == sorted(halves[1])
    for k, g in got.items():
        want = (halves[0][k] + halves[1][k]) * 0.5
        torch.testing.assert_close(g, want, rtol=1e-6, atol=1e-9, msg=k)
    for k in LOSSES:
        want = (float(mets[0][k]) + float(mets[1][k])) / 2
        np.testing.assert_allclose(float(met[k]), want, rtol=1e-6)
    for k in ("fg_cnt", "bg_cnt"):
        assert float(met[k]) == float(mets[0][k]) + float(mets[1][k])


def test_accumulation_refusals():
    _, _, params, pcfg, _ = harness.flagship()
    model = PortDetector(pcfg, dtype=torch.float32).train()
    batch = {k: T(v) for k, v in train_batch(pcfg).items()}
    three = {k: torch.cat([v, v[:1]]) for k, v in batch.items()}
    with pytest.raises(ValueError, match="not divisible"):
        grads_and_metrics(model, three, torch.Generator(), accum_steps=2)
    p = next(p for p in model.parameters() if p.requires_grad)
    p.grad = torch.zeros_like(p)
    with pytest.raises(ValueError, match="empty gradients"):
        grads_and_metrics(model, batch, torch.Generator(), accum_steps=2)


@pytest.fixture(scope="module")
def fused():
    cfg, jm, params, pcfg, pm = harness.flagship()
    u, a = 2, 2
    image, _, info = harness.batch(u)
    rng = np.random.RandomState(8)
    query = rng.randint(0, 256, (u, a, harness.Q, harness.Q, 3)).astype(
        np.uint8)
    jbatch = {"image": jnp.asarray(image), "query": jnp.asarray(query),
              "im_info": jnp.asarray(info),
              "gt_boxes": jnp.zeros((u, cfg.MAX_NUM_GT_BOXES, 5))}
    want = jax.jit(jmake_fused_eval_step(jm))(params, jbatch)
    pbatch = {"image": T(image), "query": T(query), "im_info": T(info)}
    got = make_fused_eval_step(pm)(pbatch)
    expanded = {"image": T(np.repeat(image, a, axis=0)),
                "query": T(query.reshape((u * a,) + query.shape[2:])),
                "im_info": T(np.repeat(info, a, axis=0))}
    per_pair = make_eval_step(pm)(expanded)
    return dict(want=want, got=got, per_pair=per_pair, n=u * a)


@pytest.mark.parametrize("name,atol", [("rois", 1e-2), ("cls_prob", 1e-5),
                                       ("bbox_pred", 1e-4)])
def test_fused_eval_step_matches_jax(fused, name, atol):
    want = np.asarray(fused["want"][name])
    got = fused["got"][name].numpy()
    assert got.shape == want.shape and got.shape[0] == fused["n"]
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=name)
    np.testing.assert_array_equal(fused["got"]["im_info"].numpy(),
                                  np.asarray(fused["want"]["im_info"]))


@pytest.mark.parametrize("name,atol", [("rois", 1e-2), ("cls_prob", 1e-5),
                                       ("bbox_pred", 1e-4)])
def test_fused_eval_step_equals_the_per_pair_step(fused, name, atol):
    """Pair-major rows, shot a of image u at row u * A + a; the backbone at
    batch U or U * A may sum in another order, hence the slice tolerances."""
    np.testing.assert_allclose(fused["got"][name].numpy(),
                               fused["per_pair"][name].numpy(), rtol=0,
                               atol=atol, err_msg=name)


def test_pair_image_idx_is_eval_only():
    _, _, _, _, pm = harness.flagship()
    image, query, info = (T(x) for x in harness.batch(1))
    idx = torch.zeros(1, dtype=torch.long)
    with pytest.raises(ValueError, match="eval-path"):
        pm(image, query, info, torch.zeros(1, 20, 5), train=True,
           generator=torch.Generator(), pair_image_idx=idx)
    with pytest.raises(ValueError, match="pair_image_idx maps"):
        pm(image, query, info, pair_image_idx=torch.zeros(2, dtype=torch.long))
