"""The port's box encoding and IoU, training targets, losses and ROI Align
gradient against ait_tpu's, on the CPU in float32.

Targets get the uniforms JAX draws from a key the test chose, derived with
the split sequence of ait_tpu/models/targets.py:80-84 and :145,151: labels,
rois and counts must be equal, regression targets within 1e-5 (log and
division may differ in the last ulp between XLA and PyTorch).  Box ops and
losses within 1e-6 relative (one rounding of each op); loss gradients
within 1e-5 of their max; ROI Align's gradient within 1e-5 of its max (a sum
over the same interpolation weights in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_harness import anchor_draws, proposal_draws
from ait_tpu.models import losses as jl
from ait_tpu.models import targets as jt
from ait_tpu.ops import boxes as jb
from ait_tpu.ops.anchors import shifted_anchors
from ait_tpu.ops.roi_align import roi_align as jroi_align
from ait_tpu_torch.models import losses as pl
from ait_tpu_torch.models import targets as pt
from ait_tpu_torch.ops import boxes as pb
from ait_tpu_torch.ops.roi_align import roi_align as proi_align


def T(a):
    return torch.from_numpy(np.array(a))


def random_boxes(rng, shape, extent=(800, 600), size=(8, 300)):
    xy = rng.rand(*shape, 2) * np.asarray(extent) * 0.9
    wh = size[0] + rng.rand(*shape, 2) * (size[1] - size[0])
    return np.concatenate([xy, np.minimum(xy + wh, np.asarray(extent) - 1)],
                          -1).astype(np.float32)


def test_box_encode_and_iou_match():
    rng = np.random.RandomState(0)
    ex, gt = random_boxes(rng, (3, 40)), random_boxes(rng, (3, 40))
    np.testing.assert_allclose(pb.bbox_transform(T(ex), T(gt)).numpy(),
                               np.asarray(jb.bbox_transform(ex, gt)),
                               rtol=1e-6, atol=1e-6)
    q = random_boxes(rng, (3, 5))
    np.testing.assert_allclose(pb.bbox_overlaps(T(ex), T(q)).numpy(),
                               np.asarray(jb.bbox_overlaps(ex, q)),
                               rtol=1e-6, atol=0)
    q[:, -2:] = 0.0                          # zero-padded gt boxes
    ex[0, :3] = 0.0                          # zero candidate boxes
    np.testing.assert_allclose(pb.bbox_overlaps_masked(T(ex), T(q)).numpy(),
                               np.asarray(jb.bbox_overlaps_masked(ex, q)),
                               rtol=1e-6, atol=0)


def gt_batch(rng, b, g, real):
    gt = np.zeros((b, g, 5), np.float32)
    for i, n in enumerate(real):
        gt[i, :n, :4] = random_boxes(rng, (n,), size=(40, 250))
        gt[i, :n, 4] = 1.0
    return gt


@pytest.mark.parametrize("clobber", [False, True])
def test_anchor_targets_equal(clobber):
    """The flagship's anchor set on a 608x800 canvas (17,100 anchors), one
    image cut to 500x700, 256 sampled anchors at half fg."""
    rng = np.random.RandomState(1)
    anchors = shifted_anchors(38, 50, 16)
    gt = gt_batch(rng, 3, 6, (3, 1, 6))
    info = np.asarray([[600, 800, 1.6], [500, 700, 1.6], [600, 800, 1.6]],
                      np.float32)
    key = jax.random.PRNGKey(3)
    kw = dict(batch_size=256, fg_fraction=0.5, positive_overlap=0.7,
              negative_overlap=0.3, clobber_positives=clobber)
    want = jt.anchor_targets(jnp.asarray(anchors), jnp.asarray(gt),
                             jnp.asarray(info), key, **kw)
    got = pt.anchor_targets(T(anchors), T(gt), T(info),
                            draws=anchor_draws(key, 3, anchors.shape[0]),
                            **kw)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert (got.labels == 1).sum() > 0 and (got.labels == 0).sum() > 0
    np.testing.assert_allclose(got.bbox_targets.numpy(),
                               np.asarray(want.bbox_targets), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(got.inside_weights.numpy(),
                                  np.asarray(want.inside_weights))
    np.testing.assert_allclose(got.outside_weights.numpy(),
                               np.asarray(want.outside_weights), rtol=1e-7)


@pytest.mark.parametrize("case", ["mixed", "fg_only", "bg_only"])
def test_proposal_targets_equal(case):
    """128 rois per image from 300 proposals plus the gt boxes: the usual
    fg + bg draw, and the reference's fg-only and bg-only cases."""
    rng = np.random.RandomState(2)
    b, n, r = 2, 300, 128
    gt = gt_batch(rng, b, 4, (2, 4))
    props = random_boxes(rng, (b, n))
    if case == "mixed":
        # jitter gt boxes into some proposals so that fg exists
        props[:, :40] = gt[:, :1, :4] + rng.randn(b, 40, 4).astype(
            np.float32) * 6
    elif case == "fg_only":
        props[:] = gt[:, :1, :4] + rng.randn(b, n, 4).astype(np.float32)
    else:
        gt[:] = 0.0                          # no real gt box at all
    props = np.concatenate([np.zeros((b, n, 1), np.float32), props], -1)
    key = jax.random.PRNGKey(4)
    kw = dict(rois_per_image=r, fg_fraction=0.25, fg_thresh=0.5,
              bg_thresh_hi=0.5, bg_thresh_lo=0.0 if case == "bg_only" else
              0.1)
    want = jt.proposal_targets(jnp.asarray(props), jnp.asarray(gt), key, **kw)
    got = pt.proposal_targets(T(props), T(gt),
                              draws=proposal_draws(key, b, n + 4, r), **kw)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.rois.numpy(), np.asarray(want.rois))
    np.testing.assert_allclose(got.bbox_targets.numpy(),
                               np.asarray(want.bbox_targets), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(got.inside_weights.numpy(),
                                  np.asarray(want.inside_weights))
    np.testing.assert_array_equal(got.outside_weights.numpy(),
                                  np.asarray(want.outside_weights))
    fg = int((got.labels > 0).sum())
    if case == "bg_only":
        assert fg == 0
    else:
        assert fg > 0


def test_targets_draw_from_the_generator():
    """Without injected draws, the same generator seed gives the same
    targets, another seed other ones."""
    rng = np.random.RandomState(5)
    anchors = T(shifted_anchors(38, 50, 16))
    gt = T(gt_batch(rng, 2, 3, (3, 2)))
    info = T(np.asarray([[600, 800, 1.6]] * 2, np.float32))

    def labels(seed):
        return pt.anchor_targets(anchors, gt, info, batch_size=64,
                                 generator=torch.Generator().manual_seed(
                                     seed)).labels

    assert torch.equal(labels(0), labels(0))
    assert not torch.equal(labels(0), labels(1))


def loss_inputs(seed):
    rng = np.random.RandomState(seed)
    return dict(
        logits=rng.randn(2, 50, 2).astype(np.float32) * 2,
        labels=rng.randint(-1, 2, (2, 50)).astype(np.int32),
        pred=rng.randn(2, 50, 4).astype(np.float32),
        target=rng.randn(2, 50, 4).astype(np.float32),
        iw=(rng.rand(2, 50, 4) > 0.5).astype(np.float32),
        ow=(rng.rand(2, 50, 4) / 50).astype(np.float32),
        prob=rng.rand(2, 16).astype(np.float32),
        blabels=rng.randint(0, 2, (2, 16)).astype(np.int32))


def test_losses_and_gradients_match():
    a = loss_inputs(6)
    cases = [
        (lambda lg: jl.masked_cross_entropy(lg, a["labels"],
                                            a["labels"] != -1),
         lambda lg: pl.masked_cross_entropy(lg, T(a["labels"]),
                                            T(a["labels"] != -1)),
         a["logits"]),
        (lambda p: jl.smooth_l1_loss(p, a["target"], a["iw"], a["ow"],
                                     sigma=3.0, reduce_dims=(1, 2)),
         lambda p: pl.smooth_l1_loss(p, T(a["target"]), T(a["iw"]),
                                     T(a["ow"]), sigma=3.0,
                                     reduce_dims=(1, 2)),
         a["pred"]),
        (lambda p: jl.smooth_l1_loss(p.reshape(-1, 4),
                                     a["target"].reshape(-1, 4),
                                     a["iw"].reshape(-1, 4),
                                     a["ow"].reshape(-1, 4), sigma=1.0),
         lambda p: pl.smooth_l1_loss(p.reshape(-1, 4),
                                     T(a["target"]).reshape(-1, 4),
                                     T(a["iw"]).reshape(-1, 4),
                                     T(a["ow"]).reshape(-1, 4), sigma=1.0),
         a["pred"]),
        (lambda p: jl.margin_ranking_loss(p, a["blabels"], -0.3),
         lambda p: pl.margin_ranking_loss(p, T(a["blabels"]), -0.3),
         a["prob"]),
    ]
    for jf, pf, x in cases:
        want, wgrad = jax.value_and_grad(jf)(jnp.asarray(x))
        xt = T(x).requires_grad_()
        got = pf(xt)
        (ggrad,) = torch.autograd.grad(got, xt)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
        scale = float(np.abs(np.asarray(wgrad)).max())
        np.testing.assert_allclose(ggrad.numpy(), np.asarray(wgrad), rtol=0,
                                   atol=1e-5 * scale)


def test_roi_align_gradient_matches():
    """ROI Align's backward is torch autograd through its contractions:
    against jax.grad of the JAX package's roi_align."""
    rng = np.random.RandomState(7)
    b, hh, ww, c, r = 2, 12, 17, 8, 10
    feat = rng.randn(b, hh, ww, c).astype(np.float32)
    rois = random_boxes(rng, (b, r), extent=(ww * 16, hh * 16), size=(1, 120))
    cot = rng.randn(b, r, 7, 7, c).astype(np.float32)

    def jf(f):
        return jnp.sum(jroi_align(f, jnp.asarray(rois), out_size=7,
                                  spatial_scale=1 / 16) * cot)

    want = np.asarray(jax.grad(jf)(jnp.asarray(feat)))
    ft = T(feat).requires_grad_()
    out = proi_align(ft, T(rois), out_size=7, spatial_scale=1 / 16)
    (got,) = torch.autograd.grad(out, ft, T(cot))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))
