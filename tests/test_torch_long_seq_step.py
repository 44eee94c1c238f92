"""The slice under the long-sequence policy, in both packages: the tiny
flagship's eval forward and one train step (model.t_dropout 0.1) with
`_LONG_SEQ_FUSION` on in ait_tpu and in the port, on a 160x208 canvas whose
10 x 13 = 130 image tokens are past the 128-token bound of the short regime,
so that the co-attention's two attentions (130 x 64 and 64 x 130) are fused
only because of the switch.  float32 on the CPU, one numpy-seeded param tree.

Off the TPU JAX's fused branch runs `_reference_impl` with bernoulli masks
of shape (H, B*lq, lk) and (B*lq, D), drawn attention mask then output mask
(ait_tpu/models/attention.py:239-267); the port's fused branch takes the
same masks in the same order (`Dropout.take`) and runs its plain version.
Sampling uniforms and masks are injected as in
tests/test_torch_dropout_step.py, and the tolerances are that file's
(losses 1e-4 relative; every gradient within 2e-3 of its leaf's max |JAX
gradient|, 2e-2 in the backbone and the ResNet top; rois_label equal), the
eval tolerances tests/test_torch_port_slice.py's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_harness as harness
from ait_tpu.models import attention as jattn
from ait_tpu.models import detector as jdet
from ait_tpu.models.detector import AITDetector as JaxDetector
from ait_tpu_torch import bridge
from ait_tpu_torch.models import AITDetector as PortDetector
from ait_tpu_torch.models import attention as pattn
from ait_tpu_torch.models import detector as pdet
from ait_tpu_torch.models.dropout import Dropout
from ait_tpu_torch.ops import fused_attention as pfa
from test_torch_dropout_step import (JAX_LOSS, KEEP, jax_grads_and_out,
                                     tolerance)
from test_torch_train_step import (KEY_A, KEY_P, LOSS_REL, T, get, gt_boxes,
                                   leaves)

B = 2
H, W = 160, 208
TOKENS = (H // 16) * (W // 16)


def make_batch(cfg):
    rng = np.random.RandomState(4)
    image = rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8)
    query = rng.randint(0, 256, (B, harness.Q, harness.Q, 3)).astype(np.uint8)
    info = np.tile(np.asarray([[H - 8, W - 16, 1.0]], np.float32), (B, 1))
    return {"image": image, "query": query, "im_info": info,
            "gt_boxes": gt_boxes(B, cfg.MAX_NUM_GT_BOXES),
            "num_boxes": np.ones((B,), np.int32)}


def spy_fused(mp, calls):
    real = pfa.sh_attention
    mp.setattr(pfa, "sh_attention", lambda *a, **k: calls.append(
        (a[0].shape[1], a[1].shape[1])) or real(*a, **k))


@pytest.fixture(scope="module")
def run():
    assert TOKENS == 130 > pfa.FUSE_MAX_TOKENS
    jcfg, _, params, pcfg, _ = harness.flagship()
    batch = make_batch(jcfg)
    t = jcfg.TRAIN
    n_anchors = TOKENS * len(jcfg.ANCHOR_SCALES) * len(jcfg.ANCHOR_RATIOS)
    n_p = t.RPN_POST_NMS_TOP_N + jcfg.MAX_NUM_GT_BOXES
    adraws = harness.anchor_draws(KEY_A, B, n_anchors)
    pdraws = harness.proposal_draws(KEY_P, B, n_p, t.BATCH_SIZE)

    jmodel = JaxDetector(jcfg, dtype=jnp.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    mp = pytest.MonkeyPatch()
    real_at, real_pt = jdet.anchor_targets, jdet.proposal_targets
    mp.setattr(jattn, "_LONG_SEQ_FUSION", True)
    mp.setattr(jdet, "anchor_targets",
               lambda a, g, i, key, **kw: real_at(a, g, i, KEY_A, **kw))
    mp.setattr(jdet, "proposal_targets",
               lambda r, g, key, **kw: real_pt(r, g, KEY_P, **kw))
    try:
        jeval = jax.jit(lambda p, b: jmodel.apply(
            {"params": p}, b["image"], b["query"], b["im_info"],
            jnp.zeros_like(b["gt_boxes"]), jnp.zeros((B,), jnp.int32),
            train=False))(params, jbatch)
        rec = harness.BernoulliFeed()
        mp.setattr(jax.random, "bernoulli", rec)
        jax.eval_shape(lambda p, b: jax_grads_and_out(
            jmodel, p, b, jax.random.PRNGKey(0)), params, jbatch)
        masks = harness.keep_masks(rec.shapes, KEEP, seed=6)
        mp.setattr(jax.random, "bernoulli", harness.BernoulliFeed(masks))
        grads, jout = jax.jit(lambda p, b: jax_grads_and_out(
            jmodel, p, b, jax.random.PRNGKey(0)))(params, jbatch)
    finally:
        mp.undo()

    calls = []
    with pytest.MonkeyPatch.context() as mp2:
        mp2.setattr(pattn, "_LONG_SEQ_FUSION", True)
        mp2.setattr(pdet, "anchor_targets",
                    functools.partial(pdet.anchor_targets, draws=adraws))
        mp2.setattr(pdet, "proposal_targets",
                    functools.partial(pdet.proposal_targets, draws=pdraws))
        mp2.setattr(pdet, "Dropout", lambda rate, generator=None: Dropout(
            rate, generator, masks=masks))
        model = PortDetector(pcfg, dtype=torch.float32)
        model.load_state_dict(bridge.to_state_dict(model, params))
        pbatch = {k: T(v) for k, v in batch.items()}
        spy_fused(mp2, calls)
        with torch.inference_mode():
            peval = model.eval()(pbatch["image"], pbatch["query"],
                                 pbatch["im_info"])
        eval_calls = list(calls)
        out = model.train()(*(pbatch[k] for k in (
            "image", "query", "im_info", "gt_boxes", "num_boxes")),
            train=True, generator=torch.Generator())
        out.total_loss.backward()
        pgrads = bridge.grad_tree(model)
        train_calls = calls[len(eval_calls):]
    return dict(jeval=jeval, peval=peval, grads=grads, jout=jout, out=out,
                pgrads=pgrads, shapes=rec.shapes, eval_calls=eval_calls,
                train_calls=train_calls)


def test_coattention_took_the_fused_path(run):
    """Eval: the co-attention's two long shapes, then the transformer's
    three; JAX asked for the fused branch's mask shapes, attention mask then
    output mask, for the same two."""
    assert run["eval_calls"][:2] == [(TOKENS, 64), (64, TOKENS)]
    assert len(run["eval_calls"]) == 5
    assert [c for c in run["train_calls"] if TOKENS in c] == [
        (TOKENS, 64), (64, TOKENS)]
    assert run["shapes"][:4] == [(8, B * TOKENS, 64), (B * TOKENS, 512),
                                 (8, B * 64, TOKENS), (B * 64, 512)]


def test_eval_forward_matches(run):
    for name, atol in (("rois", 1e-2), ("cls_prob", 1e-5),
                       ("bbox_pred", 1e-4)):
        want = np.asarray(getattr(run["jeval"], name))
        got = getattr(run["peval"], name).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("name", sorted(JAX_LOSS))
def test_losses_match(run, name):
    want = float(getattr(run["jout"], JAX_LOSS[name]))
    out = run["out"]
    got = float((out.total_loss if name == "loss"
                 else getattr(out, JAX_LOSS[name])).detach())
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=LOSS_REL, atol=1e-6)


def test_rois_label_equal(run):
    np.testing.assert_array_equal(run["out"].rois_label.numpy(),
                                  np.asarray(run["jout"].rois_label))


def test_every_gradient_matches(run):
    bad = []
    for path, want in leaves(run["grads"]):
        got = get(run["pgrads"], path)
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        if err > tolerance(path) * max(scale, 1e-12):
            bad.append(("/".join(path), err, scale))
    assert not bad, bad[:10]
