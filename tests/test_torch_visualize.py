"""The port's detection overlays (ait_tpu_torch/utils/visualize.py) against
ait_tpu/utils/visualize.py, which draws with cv2 (cv2 imports here, not on
the card's machine).

* `draw_detections` pixel-equal to JAX's on seeded detections: boxes that
  cross every edge of the image, scores on both sides of the threshold,
  labels at the top and right edges, other thresholds and labels;
* its two primitives against cv2 on random images, corners and strings
  (every printable character), and the committed glyph table against what
  cv2 renders (tools/port_font_table.py);
* `compose_with_query` bit-equal for uint8 and for normalized queries;
* `write_png` read back by imageio and by `read_png`, which refuses the
  PNGs it does not write.
"""

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest

from ait_tpu.utils import visualize as jvis
from ait_tpu_torch.utils import visualize as vis
from ait_tpu_torch.utils._font_plain import GLYPHS

PRINTABLE = [chr(c) for c in range(32, 127)]


def _dets(rng, h, w, n):
    """Boxes inside, across each edge and at the corners, scores around
    the threshold; float32 like the postprocess's output."""
    x1 = rng.uniform(-0.3 * w, 1.1 * w, n)
    y1 = rng.uniform(-0.3 * h, 1.1 * h, n)
    x2 = x1 + rng.uniform(0, 0.8 * w, n)
    y2 = y1 + rng.uniform(0, 0.8 * h, n)
    score = rng.uniform(0.6, 1.0, n)
    dets = np.stack([x1, y1, x2, y2, score], 1)
    # labels at the top edge (y1 < 12) and running off the right edge
    dets[0, :4] = [w - 20, 3, w + 15, h // 2]
    dets[1, :4] = [-7.9, -3.2, w / 2, 11.7]
    dets[2, :4] = [w - 1, h - 1, w + 4, h + 4]
    dets[2:5, 4] = [0.8, 0.80001, 0.79999]
    return dets.astype(np.float32)


@pytest.mark.parametrize("seed", range(8))
def test_draw_detections_equals_jax(seed):
    rng = np.random.RandomState(seed)
    h, w = int(rng.randint(40, 300)), int(rng.randint(40, 300))
    image = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    dets = _dets(rng, h, w, int(rng.randint(6, 30)))
    for kw in ({}, {"thresh": 0.7, "label": "cat"}, {"thresh": 0.0}):
        got = vis.draw_detections(image, dets, **kw)
        want = jvis.draw_detections(image, dets, **kw)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=str(kw))
    np.testing.assert_array_equal(
        vis.draw_detections(image, np.zeros((0, 5), np.float32)), image)


def test_primitives_equal_cv2():
    rng = np.random.RandomState(0)
    for _ in range(400):
        h, w = int(rng.randint(5, 60)), int(rng.randint(5, 90))
        im = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        p1 = (int(rng.randint(-20, w + 20)), int(rng.randint(-20, h + 20)))
        p2 = (int(rng.randint(-20, w + 20)), int(rng.randint(-20, h + 20)))
        got, want = im.copy(), im.copy()
        vis.rectangle(got, p1, p2, (0, 204, 0))
        cv2.rectangle(want, p1, p2, (0, 204, 0), 2)
        np.testing.assert_array_equal(got, want, err_msg=f"{p1} {p2}")
        text = "".join(rng.choice(PRINTABLE, int(rng.randint(1, 14))))
        org = (int(rng.randint(-60, w + 5)), int(rng.randint(-5, h + 20)))
        color = tuple(int(c) for c in rng.randint(0, 256, 3))
        got, want = im.copy(), im.copy()
        vis.put_text(got, text, org, color)
        cv2.putText(want, text, org, cv2.FONT_HERSHEY_PLAIN, 1.0, color, 1)
        np.testing.assert_array_equal(got, want, err_msg=f"{text!r} {org}")


def test_glyph_table_is_cv2s():
    from tools import port_font_table

    table = port_font_table.measure()
    assert sorted(table) == sorted(GLYPHS) == PRINTABLE
    for ch in PRINTABLE:
        adv, dx, dy, mask = table[ch]
        g = GLYPHS[ch]
        assert g[:5] == (adv, dx, dy, mask.shape[1], mask.shape[0]), ch
        assert bytes.fromhex(g[5]) == mask.tobytes(), ch


def test_put_text_refuses_other_characters():
    im = np.zeros((20, 40, 3), np.uint8)
    with pytest.raises(ValueError, match="printable ASCII"):
        vis.put_text(im, "é", (2, 15), (0, 0, 255))


@pytest.mark.parametrize("h", [37, 128, 375, 500])
def test_compose_with_query_equals_jax(h):
    rng = np.random.RandomState(h)
    image = rng.randint(0, 256, (h, 211, 3)).astype(np.uint8)
    q8 = rng.randint(0, 256, (128, 128, 3)).astype(np.uint8)
    qn = ((rng.uniform(0, 1, (128, 128, 3)).astype(np.float32)
           - vis.TORCHVISION_MEAN) / vis.TORCHVISION_STD).astype(np.float32)
    for q in (q8, qn, qn * 3.0):             # the last clips
        got = vis.compose_with_query(image, q)
        want = jvis.compose_with_query(image, q)
        assert got.shape == (h, 211 + h, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(vis.denormalize_query(qn),
                                  jvis.denormalize_query(qn))


@pytest.mark.parametrize("shape", [(1, 1, 3), (17, 33, 3), (64, 48),
                                   (300, 451, 3)])
def test_write_png_round_trip(tmp_path, shape):
    rng = np.random.RandomState(len(shape))
    im = rng.randint(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "x.png")
    vis.write_png(path, im)
    np.testing.assert_array_equal(imageio.imread(path), im)
    np.testing.assert_array_equal(vis.read_png(path), im)


def test_read_png_refuses_what_write_png_does_not_write(tmp_path):
    """imageio's PNGs carry filtered rows (and RGBA one more channel)."""
    yy, xx = np.mgrid[0:90, 0:120]
    im = np.stack([xx * 2, yy * 2, (xx + yy)], -1).astype(np.uint8)
    for a, match in ((im, "unfiltered rows"),
                     (np.concatenate([im, im[..., :1]], -1), "colour type")):
        path = str(tmp_path / f"{a.shape[-1]}.png")
        imageio.imwrite(path, a)
        with pytest.raises(ValueError, match=match):
            vis.read_png(path)


def test_write_png_refuses_other_arrays(tmp_path):
    with pytest.raises(ValueError, match="uint8"):
        vis.write_png(str(tmp_path / "x.png"), np.zeros((4, 4, 3)))
    with pytest.raises(ValueError, match="uint8"):
        vis.write_png(str(tmp_path / "x.png"), np.zeros((4, 4, 4), np.uint8))
