"""The port's box ops, anchors, NMS and ROI Align against ait_tpu's, on the
CPU (inputs from numpy seeds, passed to both as arrays).

Exact where both sides do the same f32 operations in the same order (box
arithmetic, anchors, the NMS keep bits); ROI Align within 1e-5, because the
two contractions sum in another order.
"""

import importlib
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ait_tpu.ops import anchors as janchors
from ait_tpu.ops import boxes as jboxes
from ait_tpu.ops.nms import batched_nms_topk as jax_nms_topk
from ait_tpu.ops.nms import nms_keep_mask as jax_keep
from ait_tpu.ops.nms_pallas import nms_keep_mask_batched as pallas_keep
from ait_tpu.ops.roi_align import roi_align as jroi_align
from ait_tpu_torch.ops import anchors as panchors
from ait_tpu_torch.ops import boxes as pboxes
from ait_tpu_torch.ops.roi_align import roi_align as proi_align

# the module (ait_tpu_torch.ops exports its `nms` function under that name)
pnms = importlib.import_module("ait_tpu_torch.ops.nms")

T = torch.from_numpy


def clustered(rng, b, n, extent=200.0):
    """Score-sorted overlapping boxes [b, n, 4] and their scores."""
    ctr = rng.rand(b, n, 2) * extent
    wh = 20 + rng.rand(b, n, 2) * 60
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    scores = rng.rand(b, n).astype(np.float32)
    order = np.argsort(-scores, axis=1)
    return (np.take_along_axis(boxes, order[..., None], 1),
            np.take_along_axis(scores, order, 1))


def first_survivors(keep, k):
    return np.where(np.asarray(keep))[0][:k]


@pytest.mark.parametrize("ratios,scales", [((0.5, 1.0, 2.0), (8, 16, 32)),
                                           ((1.0,), (4, 8))])
def test_anchors_exact(ratios, scales):
    np.testing.assert_array_equal(
        panchors.generate_anchors(ratios=ratios, scales=scales),
        janchors.generate_anchors(ratios=ratios, scales=scales))
    np.testing.assert_array_equal(
        panchors.shifted_anchors(6, 8, 16, ratios=ratios, scales=scales),
        np.asarray(janchors.shifted_anchors(6, 8, 16, ratios=ratios,
                                            scales=scales)))


def test_box_decode_and_clip_exact():
    rng = np.random.RandomState(0)
    boxes = (rng.rand(3, 50, 4) * 300).astype(np.float32)
    boxes[..., 2:] += boxes[..., :2]
    # decode without exp (dw = dh = 0): only +-*, exact on both sides
    deltas = (rng.randn(3, 50, 4) * 0.3).astype(np.float32)
    deltas[..., 2:] = 0.0
    hw = np.asarray([[200, 250], [600, 800], [90, 120]], np.float32)
    want = jboxes.clip_boxes(jboxes.bbox_transform_inv(boxes, deltas),
                             hw[:, None])
    got = pboxes.clip_boxes(pboxes.bbox_transform_inv(T(boxes), T(deltas)),
                            T(hw)[:, None])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_box_decode_with_exp_close():
    """exp differs in the last ulp between XLA's and PyTorch's CPU
    implementations; everything else is exact."""
    rng = np.random.RandomState(1)
    boxes = (rng.rand(2, 40, 4) * 300).astype(np.float32)
    boxes[..., 2:] += boxes[..., :2]
    deltas = (rng.randn(2, 40, 4) * 0.5).astype(np.float32)
    want = np.asarray(jboxes.bbox_transform_inv(boxes, deltas))
    got = pboxes.bbox_transform_inv(T(boxes), T(deltas)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("thr", [0.3, 0.5, 0.7])
@pytest.mark.parametrize("max_out", [None, 64])
def test_plain_nms_matches_xla(thr, max_out):
    rng = np.random.RandomState(2)
    boxes, _ = clustered(rng, 1, 777)
    valid = np.ones(777, bool)
    valid[-60:] = False                      # padded rows
    valid[rng.rand(777) < 0.05] = False
    want = np.asarray(jax_keep(jnp.asarray(boxes[0]), jnp.asarray(valid),
                               thr, tile=256, max_out=max_out))
    got = pnms.nms_keep_mask(T(boxes[0]), T(valid), thr, tile=256,
                             max_out=max_out).numpy()
    # the plain version is a line-by-line port of the XLA sweep: every bit
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_out", [None, 40, 300])
def test_plain_nms_matches_pallas_interpret(max_out):
    """Batched wrapper on CPU (its plain version) vs the Pallas kernel in
    interpret mode: the first max_out survivors of every image."""
    rng = np.random.RandomState(3)
    b, n = 3, 600
    boxes, _ = clustered(rng, b, n)
    valid = np.ones((b, n), bool)
    valid[0, -100:] = False
    valid[2, ::7] = False
    before = pnms.nms_keep_mask_batched.launches
    got = pnms.nms_keep_mask_batched(T(boxes), T(valid), 0.5,
                                     max_out=max_out).numpy()
    assert pnms.nms_keep_mask_batched.launches == before   # no kernel on CPU
    want = np.asarray(pallas_keep(jnp.asarray(boxes), jnp.asarray(valid),
                                  0.5, tile=256, max_out=max_out,
                                  interpret=True))
    k = n if max_out is None else max_out
    for i in range(b):
        np.testing.assert_array_equal(first_survivors(got[i], k),
                                      first_survivors(want[i], k))


def _topk_pair(boxes, scores, valid, thr, pre, post):
    want = jax_nms_topk(jnp.asarray(boxes), jnp.asarray(scores), thr, pre,
                        post, valid=jnp.asarray(valid), use_pallas=False)
    got = pnms.batched_nms_topk(T(boxes), T(scores), thr, pre, post,
                                valid=T(valid))
    return want, got


@pytest.mark.parametrize("pre,post", [(300, 64), (256, 300), (1000, 100)])
def test_batched_nms_topk_exact(pre, post):
    """Including the tile-aligned candidate take (pre not a multiple of 256)
    and the zero padding past the survivors."""
    rng = np.random.RandomState(4)
    b, n = 2, 900
    ctr = rng.rand(b, n, 2) * 300
    wh = 10 + rng.rand(b, n, 2) * 80
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    scores = rng.rand(b, n).astype(np.float32)
    valid = rng.rand(b, n) > 0.1
    want, got = _topk_pair(boxes, scores, valid, 0.6, pre, post)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_batched_nms_topk_ties():
    """Equal scores: lax.top_k takes the lower index first; the port's
    stable descending sort must do the same."""
    rng = np.random.RandomState(5)
    b, n = 2, 500
    ctr = rng.rand(b, n, 2) * 400
    boxes = np.concatenate([ctr - 10, ctr + 10], -1).astype(np.float32)
    scores = np.round(rng.rand(b, n) * 8).astype(np.float32) / 8  # 9 levels
    valid = np.ones((b, n), bool)
    want, got = _topk_pair(boxes, scores, valid, 0.5, 300, 120)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("sampling_ratio", [0, 2])
def test_roi_align_matches(sampling_ratio):
    rng = np.random.RandomState(6)
    b, hh, ww, c, r = 2, 12, 17, 8, 20
    feat = rng.randn(b, hh, ww, c).astype(np.float32)
    xy = rng.rand(b, r, 2) * np.asarray([ww * 16, hh * 16]) * 0.8
    wh = rng.rand(b, r, 2) * 120 + 1
    rois = np.concatenate([xy, np.minimum(xy + wh, [ww * 16 - 1,
                                                    hh * 16 - 1])], -1)
    rois = rois.astype(np.float32)
    rois[0, 0] = 0.0                         # a zero (padding) roi
    want = np.asarray(jroi_align(jnp.asarray(feat), jnp.asarray(rois),
                                 out_size=7, spatial_scale=1 / 16,
                                 sampling_ratio=sampling_ratio))
    got = proi_align(T(feat), T(rois), out_size=7, spatial_scale=1 / 16,
                     sampling_ratio=sampling_ratio).numpy()
    assert got.shape == (b, r, 7, 7, c)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_postprocess_matches():
    from ait_tpu.evaluation.postprocess import postprocess_detections as jpp
    from ait_tpu_torch.evaluation.postprocess import \
        postprocess_detections as ppp

    rng = np.random.RandomState(7)
    b, r = 2, 300
    xy = rng.rand(b, r, 2) * 500
    rois = np.concatenate([np.zeros((b, r, 1)), xy,
                           xy + 20 + rng.rand(b, r, 2) * 200], -1)
    rois = rois.astype(np.float32)
    rois[:, -30:] = 0.0                          # padding rows
    cls = rng.rand(b, r, 1).astype(np.float32)
    cls[0, :150, 0] = 0.75                       # ties at the 100-cut
    pred = (rng.randn(b, r, 4) * 0.5).astype(np.float32)
    info = np.asarray([[600, 800, 1.6], [600, 700, 1.2]], np.float32)
    wd, wv = jpp(jnp.asarray(rois), jnp.asarray(cls), jnp.asarray(pred),
                 jnp.asarray(info))
    gd, gv = ppp(T(rois), T(cls), T(pred), T(info))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    # decoded coordinates differ by exp's last ulp (see above)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-5,
                               atol=1e-3)
