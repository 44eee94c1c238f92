"""The port's host image preparation (ait_tpu_torch/data/transforms.py)
against cv2 and ait_tpu.data.transforms.

The port's bilinear resize stands in for `cv2.resize(..., INTER_LINEAR)`,
which the GPU machine lacks.  uint8: at most 1 LSB from cv2 on at most
0.1% of the pixels (measured here against cv2 5.0.0: bit-equal at every
shape and scale below); float32: within 1e-5 (measured <= 2e-7, the order
of cv2's fused multiply-adds).  Everything built on it (`prep_image`,
`crop_query`) and the numpy helpers must then equal ait_tpu's bit for bit.
"""

import cv2
import numpy as np
import pytest

from ait_tpu.data import transforms as jt
from ait_tpu_torch.data import transforms as pt

U8_MAX_LSB = 1
U8_OFF_SHARE = 1e-3
F32_ATOL = 1e-5

# (source h, w, scale): upscales to the 600 scale (VOC 375x500, 333x500,
# a portrait and a small crop), exact 2x (cv2 switches to its area mode,
# also at odd sizes, where the last blocks are cut), 2/3, and a scale that
# rounds the size (128/53)
SCALES = [(375, 500, 1.6), (333, 500, 600 / 333), (500, 375, 1.216),
          (37, 53, 128 / 53), (120, 160, 0.5), (121, 161, 0.5),
          (123, 163, 0.5), (300, 400, 2 / 3), (80, 100, 7.5), (64, 48, 1.0)]
DSIZES = [((256, 256), (128, 128)), ((53, 53), (128, 128)),
          ((300, 300), (128, 128)), ((37, 90), (128, 41))]


def _image(h, w, seed):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(
        np.uint8)


def _check_u8(got, want):
    assert got.shape == want.shape and got.dtype == np.uint8
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= U8_MAX_LSB
    assert (d > 0).mean() <= U8_OFF_SHARE


@pytest.mark.parametrize("h,w,s", SCALES)
def test_resize_scale_matches_cv2(h, w, s):
    im = _image(h, w, h * w)
    want = cv2.resize(im, None, None, fx=s, fy=s,
                      interpolation=cv2.INTER_LINEAR)
    _check_u8(pt.resize_linear(im, fx=s, fy=s), want)
    f = pt.normalize(im)
    want_f = cv2.resize(f, None, None, fx=s, fy=s,
                        interpolation=cv2.INTER_LINEAR)
    got_f = pt.resize_linear(f, fx=s, fy=s)
    assert got_f.dtype == np.float32
    np.testing.assert_allclose(got_f, want_f, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("src,dst", DSIZES)
def test_resize_dsize_matches_cv2(src, dst):
    im = _image(src[0], src[1], 5)
    want = cv2.resize(im, dst, interpolation=cv2.INTER_LINEAR)
    _check_u8(pt.resize_linear(im, dst), want)
    f = im.astype(np.float32) / 255.0
    np.testing.assert_allclose(
        pt.resize_linear(f, dst),
        cv2.resize(f, dst, interpolation=cv2.INTER_LINEAR), rtol=0,
        atol=F32_ATOL)


def test_resize_random_shapes_match_cv2():
    rng = np.random.RandomState(1)
    for i in range(40):
        h, w = (int(v) for v in rng.randint(2, 200, 2))
        im = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        if i % 2:
            s = float(rng.uniform(0.3, 6.0))
            want = cv2.resize(im, None, None, fx=s, fy=s,
                              interpolation=cv2.INTER_LINEAR)
            got = pt.resize_linear(im, fx=s, fy=s)
        else:
            d = (int(rng.randint(1, 200)), int(rng.randint(1, 200)))
            want = cv2.resize(im, d, interpolation=cv2.INTER_LINEAR)
            got = pt.resize_linear(im, d)
        _check_u8(got, want.reshape(got.shape))


@pytest.mark.parametrize("keep_uint8", [True, False])
@pytest.mark.parametrize("h,w,max_hw", [(375, 500, (608, 800)),
                                        (500, 375, (800, 608)),
                                        (300, 900, (608, 800)),
                                        (90, 110, None)])
def test_prep_image_matches_ait_tpu(h, w, max_hw, keep_uint8):
    im = _image(h, w, 3)
    got, s = pt.prep_image(im, 600, max_hw, keep_uint8=keep_uint8)
    want, s_want = jt.prep_image(im, 600, max_hw, keep_uint8=keep_uint8)
    assert s == s_want
    if keep_uint8:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("box", [(10, 20, 90, 60), (0, 0, 256, 256),
                                 (5, 5, 5, 40), (30.7, 12.2, 61.9, 140.5)])
def test_crop_query_matches_ait_tpu(box):
    im = _image(200, 300, 9)
    np.testing.assert_array_equal(pt.crop_query(im, box, 128),
                                  jt.crop_query(im, box, 128))
    grey = im[..., 0]
    np.testing.assert_array_equal(pt.crop_query(grey, box, 64),
                                  jt.crop_query(grey, box, 64))


def test_place_on_canvas_space_to_depth_normalize_match_ait_tpu():
    rng = np.random.RandomState(4)
    im = rng.randint(0, 256, (50, 70, 3)).astype(np.uint8)
    for canvas in ((64, 80), (40, 60)):
        c = pt.place_on_canvas(im, canvas)
        np.testing.assert_array_equal(c, jt.place_on_canvas(im, canvas))
        np.testing.assert_array_equal(pt.space_to_depth(c),
                                      jt.space_to_depth(c))
    f = pt.normalize(im)
    np.testing.assert_array_equal(f, jt.normalize(im))
    np.testing.assert_array_equal(pt.place_on_canvas(f, (64, 80)),
                                  jt.place_on_canvas(f, (64, 80)))
    batch = rng.randint(0, 256, (2, 8, 12, 3)).astype(np.uint8)
    np.testing.assert_array_equal(pt.space_to_depth(batch),
                                  jt.space_to_depth(batch))
    assert pt.CANVAS_FILL == (124, 116, 104)
    with pytest.raises(ValueError, match="even"):
        pt.space_to_depth(np.zeros((3, 4, 3), np.uint8))


def test_to_rgb3_matches_ait_tpu():
    rng = np.random.RandomState(2)
    for im in (rng.randint(0, 256, (6, 7)).astype(np.uint8),
               rng.randint(0, 256, (6, 7, 4)).astype(np.uint8),
               rng.randint(0, 256, (6, 7, 3)).astype(np.uint8)):
        np.testing.assert_array_equal(pt.to_rgb3(im), jt.to_rgb3(im))
