"""The port's native route (ait_tpu_torch/native.py, csrc/ait_loader.cpp,
csrc/ait_native.cpp), built with g++ at first use.

* The C++ resize, canvas, space-to-depth and query crop against the numpy
  transforms (ait_tpu_torch/data/transforms.py), bit-equal, on odd sizes,
  an exact 2x, up- and down-scaling, portrait, wide and tiny images, both
  flips; the fused space-to-depth emit against the separate pass.
* The loader's epochs on the native route against the numpy route
  (`_use_native` patched off, as a caller has no flag for it), bit-equal
  on every key of every train and eval batch of VOC and COCO epochs, at 1,
  2 and 8 threads; the metadata against ait_tpu's epochs.
* The COCO eval loops against the port's numpy versions and ait_tpu's
  numpy versions (ait_tpu.native off), bit-equal, and the whole COCO
  evaluation's stats equal on either route.
* A failed build raises (a missing compiler, a compiler that fails); an
  image the C++ cannot take raises.
"""

import os
import sys

import numpy as np
import pytest

from ait_tpu import native as jnative
from ait_tpu.config import Config as JaxConfig
from ait_tpu.data import OneShotLoader as JaxLoader
from ait_tpu.data import voc as jvoc
from ait_tpu.evaluation import coco_eval as jcoco_eval
from ait_tpu_torch import native
from ait_tpu_torch.config import Config
from ait_tpu_torch.data import OneShotLoader, coco, transforms as T, voc
from ait_tpu_torch.evaluation import coco_eval
from ait_tpu_torch.ops import _build

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from fixtures import make_coco_devkit, make_voc_devkit  # noqa: E402

FILL = np.array(T.CANVAS_FILL, np.uint8)


@pytest.fixture(scope="module")
def voc_devkit(tmp_path_factory):
    return make_voc_devkit(str(tmp_path_factory.mktemp("VOCdevkit2007")))


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    return make_coco_devkit(str(tmp_path_factory.mktemp("coco_native")))


def _image(h, w, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(
        np.uint8)


# ------------------------------------------------------------ pixels

# (image h, w, target, canvas): down and up, odd, portrait, wide (capped by
# the canvas), an exact 2x (min side 1200 -> 600), odd sides at 2x, tiny
TARGET_CASES = [
    (375, 500, 600, (608, 800)), (500, 375, 600, (800, 608)),
    (330, 600, 600, (608, 1216)), (330, 900, 600, (608, 800)),
    (101, 77, 600, (800, 608)), (1200, 1600, 600, (608, 800)),
    (1200, 1601, 600, (608, 808)), (1202, 1603, 601, (608, 808)),
    (6, 9, 3, (4, 6)), (7, 5, 16, (32, 32)), (2, 3, 600, (608, 800)),
    (599, 801, 600, (608, 800)), (37, 1000, 64, (64, 96))]


@pytest.mark.parametrize("h,w,target,canvas", TARGET_CASES)
def test_targets_bit_equal_numpy(h, w, target, canvas):
    im = _image(h, w, seed=h * 7 + w)
    for flip in (False, True):
        src = im[:, ::-1] if flip else im
        ref, scale = T.prep_image(src, target, max_hw=canvas,
                                  keep_uint8=True)
        want = T.place_on_canvas(ref, canvas)
        out, info, scales = native.prep_targets([im], [flip], target,
                                                canvas, FILL, 2)
        np.testing.assert_array_equal(out[0], want)
        assert scales[0] == scale
        np.testing.assert_array_equal(
            info[0], np.array([ref.shape[0], ref.shape[1], scale],
                              np.float32))
        if canvas[0] % 2 == 0 and canvas[1] % 2 == 0:
            fused, _, _ = native.prep_targets([im], [flip], target, canvas,
                                              FILL, 2, s2d=True)
            np.testing.assert_array_equal(fused[0], T.space_to_depth(want))
            np.testing.assert_array_equal(
                native.space_to_depth(out, 2)[0], fused[0])


@pytest.mark.parametrize("qs", [128, 64, 17])
def test_queries_bit_equal_numpy(qs):
    im = _image(300, 257, seed=qs)
    boxes = [[0, 0, 257, 300], [1.7, 2.2, 154.2, 270.9], [5, 3, 5, 9],
             [-3, 2, 300, 299], [10, 20, 10 + 2 * qs, 20 + 2 * qs],
             [0, 0, 1, 1], [100, 10, 103, 250]]
    for flip in (False, True):
        want = [T.crop_query(im, b, qs) for b in boxes]
        want = np.stack([q[:, ::-1] if flip else q for q in want])
        got = native.prep_queries([im] * len(boxes), boxes,
                                  [flip] * len(boxes), qs, 3)
        np.testing.assert_array_equal(got, want)


def test_images_the_cpp_cannot_take_raise():
    with pytest.raises(ValueError, match="HxWx3 uint8"):
        native.prep_targets([np.zeros((8, 8, 3), np.float32)], [0], 8,
                            (8, 8), FILL)
    with pytest.raises(ValueError, match="HxWx3 uint8"):
        native.prep_queries([np.zeros((8, 8), np.uint8)], [[0, 0, 4, 4]],
                            [0], 8)


# ------------------------------------------------------------ epochs

def _route(loader, monkeypatch, use_native):
    monkeypatch.setattr(loader, "_use_native",
                        (lambda: True) if use_native else (lambda: False))


def _epochs(make, monkeypatch, training, workers, batch=2):
    runs = []
    for use_native in (True, False):
        ld = make()
        _route(ld, monkeypatch, use_native)
        epoch = ld.train_epoch if training else ld.test_epoch
        runs.append(list(epoch(batch, num_workers=workers)))
    return runs


def _same_batches(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.mark.parametrize("workers", [1, 2, 8])
@pytest.mark.parametrize("training", [True, False])
def test_voc_epochs_native_equal_numpy(voc_devkit, monkeypatch, training,
                                       workers):
    seen = 1 if training else 2

    def make():
        view = voc.filter_seen(voc.load_voc(voc_devkit, "2007", "test"), seen)
        return OneShotLoader(view, Config(), training=training, seed=4)

    assert make()._use_native()                 # uint8: the native route
    nat, ref = _epochs(make, monkeypatch, training, workers)
    _same_batches(nat, ref)
    assert nat[0]["image"].shape[-1] == 12      # host space-to-depth


@pytest.mark.parametrize("training", [True, False])
def test_coco_epochs_native_equal_numpy(coco_root, monkeypatch, training):
    data = os.path.join(coco_root, "coco")

    def make():
        view = coco.filter_seen(coco.load_coco(data, "2017", "val"), 2, 1)
        return OneShotLoader(view, Config(), training=training, seed=6)

    nat, ref = _epochs(make, monkeypatch, training, 3)
    _same_batches(nat, ref)


@pytest.mark.parametrize("training", [True, False])
def test_native_epoch_metadata_matches_ait_tpu(voc_devkit, training):
    seen = 1 if training else 2
    pl = OneShotLoader(voc.filter_seen(
        voc.load_voc(voc_devkit, "2007", "test"), seen), Config(),
        training=training, seed=0)
    jl = JaxLoader(jvoc.filter_seen(
        jvoc.load_voc(voc_devkit, "2007", "test"), seen), JaxConfig(),
        training=training, seed=0)
    epoch = "train_epoch" if training else "test_epoch"
    got = list(getattr(pl, epoch)(2, num_workers=2))
    want = list(getattr(jl, epoch)(2, num_workers=2))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for k in g:
            assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype
            if k not in ("image", "query"):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_float_inputs_take_the_numpy_route(voc_devkit, monkeypatch):
    import dataclasses

    cfg = Config()
    cfg = cfg.replace(tpu=dataclasses.replace(cfg.tpu, input_uint8=False))
    ld = OneShotLoader(voc.filter_seen(
        voc.load_voc(voc_devkit, "2007", "test"), 2), cfg, training=False)
    assert not ld._use_native()
    batch = next(ld.test_epoch(2, num_workers=1))
    assert batch["image"].dtype == np.float32


def test_native_route_raises_on_other_images(voc_devkit):
    ld = OneShotLoader(voc.filter_seen(
        voc.load_voc(voc_devkit, "2007", "test"), 2), Config(),
        training=False, imread=lambda p: np.zeros((20, 30, 3), np.float32))
    with pytest.raises(ValueError, match="HxWx3 uint8"):
        next(ld.test_epoch(2, num_workers=2))


# ------------------------------------------------------- COCO eval loops

def _coco_case(seed, d_n=40, g_n=12):
    rng = np.random.RandomState(seed)
    dt = np.concatenate([rng.uniform(0, 200, (d_n, 2)),
                         rng.uniform(0, 80, (d_n, 2))], axis=1)
    gt = np.concatenate([rng.uniform(0, 200, (g_n, 2)),
                         rng.uniform(0, 80, (g_n, 2))], axis=1)
    dt[:5] = gt[:5] + rng.uniform(-3, 3, (5, 4))   # good overlaps
    dt[5] = gt[6]                                  # exact ties
    dt[6, 2:] = 0                                  # empty boxes
    gt[7, 2:] = 0
    crowd = (rng.rand(g_n) < 0.2).astype(np.uint8)
    ignore = np.sort(rng.rand(g_n) < 0.3).astype(np.uint8)  # ignore-last
    return dt, gt, crowd, ignore


@pytest.mark.parametrize("seed", range(4))
def test_coco_loops_bit_equal_numpy(seed, monkeypatch):
    dt, gt, crowd, ignore = _coco_case(seed)
    thrs = np.linspace(0.5, 0.95, 10)
    ious = coco_eval.bbox_iou_xywh(dt, gt, crowd)
    ref = coco_eval.bbox_iou_xywh_reference(dt, gt, crowd)
    monkeypatch.setattr(jnative, "available", lambda: False)
    jref = jcoco_eval.bbox_iou_xywh(dt, gt, crowd)
    np.testing.assert_array_equal(ious, ref)
    np.testing.assert_array_equal(ious, jref)
    got = coco_eval.greedy_match(ious, ignore, crowd, thrs)
    want = coco_eval.greedy_match_reference(ious, ignore, crowd, thrs)
    jwant = jcoco_eval.greedy_match(ious, ignore, crowd, thrs)
    for g, w, jw in zip(got, want, jwant):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, jw)
    assert got[0].any()
    assert native.bbox_iou_xywh(dt[:0], gt, crowd).shape == (0, len(gt))


def test_coco_eval_stats_equal_on_both_routes(coco_root, monkeypatch):
    data = os.path.join(coco_root, "coco")
    view = coco.load_coco(data, "2017", "val")
    gt = view.coco_gt
    rng = np.random.RandomState(0)
    dets = []
    for ann in gt.annotations:
        for k in range(3):
            box = np.asarray(ann["bbox"], np.float64) + rng.uniform(-4, 4, 4)
            dets.append({"image_id": ann["image_id"],
                         "category_id": ann["category_id"],
                         "bbox": [float(v) for v in box],
                         "score": float(rng.rand())})

    def stats():
        ev = coco_eval.COCODetEval(gt, dets)
        ev.evaluate()
        ev.accumulate()
        ev.summarize()
        return np.asarray(ev.stats)

    nat = stats()
    monkeypatch.setattr(coco_eval, "bbox_iou_xywh",
                        coco_eval.bbox_iou_xywh_reference)
    monkeypatch.setattr(coco_eval, "greedy_match",
                        coco_eval.greedy_match_reference)
    np.testing.assert_array_equal(nat, stats())
    assert np.isfinite(nat).all() and nat[0] > 0


def test_nms_xyxy_matches_ait_tpu():
    rng = np.random.RandomState(1)
    xy = rng.uniform(0, 100, (60, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 40, (60, 2))], axis=1)
    for thresh in (0.3, 0.7):
        np.testing.assert_array_equal(native.nms_xyxy(boxes, thresh),
                                      jnative.nms_xyxy(boxes, thresh))


# --------------------------------------------------------------- builds

@pytest.mark.parametrize("compiler", ["missing", "failing"])
def test_failed_build_raises(tmp_path, monkeypatch, compiler):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(native, "_LIBS", {})
    if compiler == "missing":
        monkeypatch.setattr(_build, "host_compiler",
                            lambda: str(tmp_path / "no-such-g++"))
        match = "could not run"
    else:
        monkeypatch.setenv("CXX", "false")
        match = "failed for csrc/ait_loader.cpp"
    with pytest.raises(RuntimeError, match=match):
        native.available()
    with pytest.raises(RuntimeError):
        native.bbox_iou_xywh(np.zeros((1, 4)), np.zeros((1, 4)),
                             np.zeros(1, np.uint8))
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".so")]
