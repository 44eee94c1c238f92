"""The port's convergence smoke (ait_tpu_torch/tools/overfit_smoke.py)
against tools/overfit_smoke.py on the CPU.

* `make_dataset`: the images bit-equal to the arrays the JAX tool hands to
  `imageio.imwrite` (captured; the JAX tool then writes JPEG, the port keeps
  the arrays), with the same records, boxes, classes and query pools;
* the filled disc bit-equal to `cv2.circle(..., -1)` at every radius the
  dataset draws (35-69) and 70, inside the image and across each edge; the
  filled square to `cv2.rectangle(..., -1)`;
* `main` on a tiny flagship for 2 steps of 2 images: a finite RESULT line
  and a mAP in [0, 1].
"""

import dataclasses
import os
import re

import cv2
import jax
import numpy as np
import pytest
import torch

from ait_tpu_torch.config import Config
from ait_tpu_torch.tools import overfit_smoke

# the JAX tool makes rbg JAX's default generator when imported: keep this
# worker's default as it was for the tests that follow
_prng = jax.config.jax_default_prng_impl
from tools import overfit_smoke as jax_smoke  # noqa: E402
jax.config.update("jax_default_prng_impl", _prng)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on the CPU's
    cores, and each torch process would otherwise start one a core."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("shapes"))
    written = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_smoke.imageio, "imwrite",
                   lambda path, im: written.__setitem__(path, im.copy()))
        jview = jax_smoke.make_dataset(root)
    view, images = overfit_smoke.make_dataset()
    return jview, written, view, images


def _stem(path):
    return os.path.splitext(os.path.basename(path))[0]


def test_images_bit_equal(both):
    jview, written, view, images = both
    assert len(written) == len(images) == 24
    for jrec, rec in zip(jview.records, view.records):
        got, want = images[rec.image_path], written[jrec.image_path]
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=rec.image_path)


def test_records_and_query_pools_equal(both):
    jview, _, view, _ = both
    assert view.name == jview.name and view.classes == jview.classes
    assert view.allowed_classes == jview.allowed_classes
    assert len(view.records) == len(jview.records)
    for jrec, rec in zip(jview.records, view.records):
        assert _stem(rec.image_path) == _stem(jrec.image_path)
        assert (rec.img_id, rec.width, rec.height, rec.flipped) == \
            (jrec.img_id, jrec.width, jrec.height, jrec.flipped)
        for f in ("boxes", "gt_classes", "difficult"):
            a, b = getattr(rec, f), getattr(jrec, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert sorted(view.cat_data) == sorted(jview.cat_data)
    for c in view.cat_data:
        assert len(view.cat_data[c]) == len(jview.cat_data[c])
        for a, b in zip(view.cat_data[c], jview.cat_data[c]):
            assert _stem(a.image_path) == _stem(b.image_path)
            assert a.box.dtype == b.box.dtype
            np.testing.assert_array_equal(a.box, b.box)


@pytest.mark.parametrize("r", list(range(35, 71)))
def test_disc_equals_cv2(r):
    rng = np.random.RandomState(r)
    h, w = 160, 180
    im = rng.randint(90, 150, (h, w, 3)).astype(np.uint8)
    centres = [(w // 2, h // 2),                  # inside
               (3, h // 2), (w - 4, h // 2),      # across left / right
               (w // 2, 2), (w // 2, h - 3),      # across top / bottom
               (-r + 1, -r + 1), (w + r - 2, h + r - 2),  # corners
               (-r - 5, h // 2)]                  # wholly outside
    for c in centres:
        got, want = im.copy(), im.copy()
        overfit_smoke.fill_disc(got, c, r, (60, 60, 230))
        cv2.circle(want, c, r, (60, 60, 230), -1)
        np.testing.assert_array_equal(got, want, err_msg=str(c))


def test_square_equals_cv2():
    rng = np.random.RandomState(0)
    im = rng.randint(90, 150, (120, 140, 3)).astype(np.uint8)
    for _ in range(200):
        x, y = rng.randint(-80, 160, 2)
        size = int(rng.randint(0, 140))
        p1, p2 = (int(x), int(y)), (int(x) + size, int(y) + size)
        got, want = im.copy(), im.copy()
        overfit_smoke.fill_rect(got, p1, p2, (230, 220, 40))
        cv2.rectangle(want, p1, p2, (230, 220, 40), -1)
        np.testing.assert_array_equal(got, want, err_msg=f"{p1} {p2}")


def test_main_on_a_tiny_flagship(capsys):
    cfg = Config()
    cfg = cfg.replace(
        TRAIN=dataclasses.replace(cfg.TRAIN, SCALES=(64,), MAX_SIZE=96,
                                  RPN_PRE_NMS_TOP_N=64,
                                  RPN_POST_NMS_TOP_N=16, RPN_BATCHSIZE=16,
                                  BATCH_SIZE=8),
        TEST=dataclasses.replace(cfg.TEST, SCALES=(64,), MAX_SIZE=96,
                                 RPN_PRE_NMS_TOP_N=32, RPN_POST_NMS_TOP_N=8),
        tpu=dataclasses.replace(cfg.tpu, image_size=(64, 96),
                                portrait_bucket=False, wide_buckets=()))
    m = overfit_smoke.main(["--steps", "2", "--bs", "2"], cfg=cfg,
                           device="cpu")
    out = capsys.readouterr().out
    line = re.search(r"RESULT: loss (\S+) -> (\S+), train-set mAP = (\S+)",
                     out)
    assert line, out
    first, final, pct = (float(v) for v in line.groups())
    assert np.isfinite([first, final, pct]).all()
    assert 0.0 <= m <= 1.0 and abs(pct - 100 * m) < 0.051
    assert "trained 2 steps" in out
