"""The port's evaluation (ait_tpu_torch/evaluation: voc_eval, voc_results,
coco_eval) and its raw-image predictor entry points against ait_tpu's, on
the same detections and images.

VOC AP exactly equal; the devkit result files byte-equal; the 12 COCO
stats within 1e-12 (against ait_tpu on its native C++ loops and on its
numpy ones); `predict_batch`'s prepared canvases within 1 LSB of ait_tpu's
`_prep_pair` (measured bit-equal) and im_info bit-equal; `predict_batch`
equal to `predict_prepared` on those canvases (tiny flagship, CPU).
"""

import dataclasses
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from ait_tpu import native
from ait_tpu.data.coco import COCOGt as JaxCOCOGt
from ait_tpu.data.voc import load_voc as jax_load_voc
from ait_tpu.evaluation import coco_eval as jce
from ait_tpu.evaluation import voc_eval as jve
from ait_tpu.evaluation import voc_results as jvr
from ait_tpu.predict import OneShotPredictor as JaxPredictor
from ait_tpu_torch.data.coco import COCOGt
from ait_tpu_torch.data.records import ImageRecord
from ait_tpu_torch.data.voc import class_order, load_voc, split_classes
from ait_tpu_torch.evaluation import coco_eval as pce
from ait_tpu_torch.evaluation import voc_eval as pve
from ait_tpu_torch.evaluation import voc_results as pvr
from ait_tpu_torch.predict import OneShotPredictor

import torch_port_harness as harness

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from fixtures import make_voc_devkit  # noqa: E402


@pytest.fixture(scope="module")
def devkit(tmp_path_factory):
    return make_voc_devkit(str(tmp_path_factory.mktemp("VOCdevkit2007")))


def _random_dets(records, class_inds, seed):
    """Random detections per (class, image), 0-based, with near-gt hits
    (the generator of test_data_voc.py's reference check)."""
    rng = np.random.RandomState(seed)
    all_boxes = {ci: {} for ci in class_inds}
    for ci in class_inds:
        for idx, rec in enumerate(records):
            n = rng.randint(0, 4)
            dets = np.zeros((n, 5), np.float32)
            for k in range(n):
                x1 = rng.uniform(0, rec.width - 20)
                y1 = rng.uniform(0, rec.height - 20)
                dets[k] = [x1, y1, x1 + rng.uniform(10, 60),
                           y1 + rng.uniform(10, 60), rng.rand()]
            for bi, c in enumerate(rec.gt_classes):
                if c == ci and rng.rand() < 0.7:
                    b = rec.boxes[bi]
                    hit = np.array([[b[0] + 1, b[1] - 1, b[2] + 2, b[3],
                                     rng.rand()]], np.float32)
                    dets = np.concatenate([dets, hit])
            all_boxes[ci][idx] = dets
    return all_boxes


def test_voc_ap_equals_ait_tpu():
    rng = np.random.RandomState(0)
    for _ in range(20):
        n = rng.randint(1, 40)
        rec = np.sort(rng.rand(n))
        prec = rng.rand(n)
        for m07 in (True, False):
            assert pve.voc_ap(rec, prec, m07) == jve.voc_ap(rec, prec, m07)


@pytest.mark.parametrize("seen", [1, 2, 3])
@pytest.mark.parametrize("m07,quantize", [(True, False), (False, False),
                                          (True, True)])
def test_evaluate_voc_equals_ait_tpu(devkit, seen, m07, quantize):
    view = load_voc(devkit, "2007", "test")
    jview = jax_load_voc(devkit, "2007", "test")
    inds, names = split_classes(seen), class_order(seen)
    all_boxes = _random_dets(view.records, inds, seed=seen)
    got = pve.evaluate_voc(all_boxes, view.records, inds, names,
                           use_07_metric=m07, file_quantize=quantize)
    want = jve.evaluate_voc(all_boxes, jview.records, inds, names,
                            use_07_metric=m07, file_quantize=quantize)
    assert got == want
    assert any(v > 0 for v in got.values())


def test_evaluate_voc_ground_truth_gives_ap_1(devkit):
    """The ground truth as detections (score 1, 0-based boxes): AP 1 for
    every class with a non-difficult box (the 11-point sum of eleven
    1/11 rounds to 1 + 2e-16)."""
    view = load_voc(devkit, "2007", "test")
    inds, names = split_classes(3), class_order(3)
    all_boxes = {ci: {} for ci in inds}
    for idx, rec in enumerate(view.records):
        for ci in inds:
            m = rec.gt_classes == ci
            all_boxes[ci][idx] = np.concatenate(
                [rec.boxes[m], np.ones((int(m.sum()), 1), np.float32)], 1)
    res = pve.evaluate_voc(all_boxes, view.records, inds, names)
    present = {names[i] for i, ci in enumerate(inds)
               if any(((r.gt_classes == ci) & (r.difficult == 0)).any()
                      for r in view.records)}
    assert present and all(abs(res[c] - 1.0) < 1e-12 for c in present)


def _rec(name, port=True):
    cls = ImageRecord if port else jvr.ImageRecord
    return cls(img_id=name, image_path=f"/x/JPEGImages/{name}.jpg",
               width=100, height=100, boxes=np.zeros((0, 4), np.float32),
               gt_classes=np.zeros((0,), np.int32),
               difficult=np.zeros((0,), np.int32))


def test_voc_results_files_byte_equal(devkit, tmp_path):
    view = load_voc(devkit, "2007", "test")
    inds = split_classes(3)
    all_boxes = _random_dets(view.records, inds, seed=9)
    all_boxes[inds[0]][1] = np.zeros((0, 5), np.float32)   # skipped
    tag = pvr.comp_id_tag(1, 10, "0.0.0")
    assert tag == jvr.comp_id_tag(1, 10, "0.0.0")
    got = pvr.write_voc_results_files(
        all_boxes, view.records, view.classes, str(tmp_path / "port"),
        "2007", "test", tag, use_salt=False)
    want = jvr.write_voc_results_files(
        all_boxes, jax_load_voc(devkit, "2007", "test").records,
        view.classes, str(tmp_path / "jax"), "2007", "test", tag,
        use_salt=False)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want] and len(got) == 20
    for a, b in zip(got, want):
        assert open(a, "rb").read() == open(b, "rb").read()
    p = pvr.write_experiment_info(tag, str(tmp_path / "experiment.info"))
    assert pvr.read_experiment_info(p) == jvr.read_experiment_info(p) == tag
    records = [_rec("000001")]
    boxes = {1: {0: np.array([[1, 1, 2, 2, 0.5]], np.float32)}}
    p1 = pvr.write_voc_results_files(boxes, records, ("__background__",
                                                      "dog"),
                                     str(tmp_path), "2007", "test", "comp")
    p2 = pvr.write_voc_results_files(boxes, records, ("__background__",
                                                      "dog"),
                                     str(tmp_path), "2007", "test", "comp")
    assert p1[0] != p2[0]                       # the uuid salt


def _coco_dataset(tmp_path, seed=0):
    """Random gt (15% crowd) and detections with jittered gt copies (the
    generator of test_coco_eval.py)."""
    rng = np.random.RandomState(seed)
    cat_ids = [1, 2, 3, 5, 7, 9]
    images, anns, dets = [], [], []
    aid = 1
    for img_id in range(1, 9):
        w, h = int(rng.randint(200, 400)), int(rng.randint(150, 300))
        images.append({"id": img_id, "width": w, "height": h,
                       "file_name": f"{img_id:012d}.jpg"})
        for _ in range(rng.randint(1, 6)):
            cat = int(rng.choice(cat_ids))
            bw, bh = float(rng.uniform(8, 150)), float(rng.uniform(8, 150))
            x, y = float(rng.uniform(0, w - bw)), float(rng.uniform(0, h - bh))
            anns.append({"id": aid, "image_id": img_id, "category_id": cat,
                         "bbox": [x, y, bw, bh], "area": bw * bh,
                         "iscrowd": int(rng.rand() < 0.15)})
            aid += 1
    for img_id in range(1, 9):
        im = images[img_id - 1]
        for _ in range(rng.randint(3, 15)):
            cat = int(rng.choice(cat_ids))
            bw, bh = float(rng.uniform(8, 150)), float(rng.uniform(8, 150))
            x = float(rng.uniform(0, im["width"] - bw))
            y = float(rng.uniform(0, im["height"] - bh))
            dets.append({"image_id": img_id, "category_id": cat,
                         "bbox": [x, y, bw, bh], "score": float(rng.rand())})
    for ann in anns:
        if rng.rand() < 0.6:
            x, y, bw, bh = ann["bbox"]
            dets.append({"image_id": ann["image_id"],
                         "category_id": ann["category_id"],
                         "bbox": [x + rng.uniform(-4, 4),
                                  y + rng.uniform(-4, 4),
                                  bw * rng.uniform(0.85, 1.15),
                                  bh * rng.uniform(0.85, 1.15)],
                         "score": float(rng.rand())})
    doc = {"images": images, "annotations": anns,
           "categories": [{"id": c, "name": f"cat{c}"} for c in cat_ids]}
    path = tmp_path / "instances_test.json"
    path.write_text(json.dumps(doc))
    return str(path), dets


def _coco_stats(mod, gt, dets, class_index=None):
    ev = mod.COCODetEval(gt, dets)
    ev.evaluate()
    ev.accumulate()
    return ev, ev.summarize(class_index=class_index, verbose=False)


@pytest.mark.parametrize("jax_native", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_coco_stats_match_ait_tpu(tmp_path, monkeypatch, jax_native, seed):
    if jax_native and not native.available():
        pytest.skip("ait_tpu's native library is not built")
    if not jax_native:
        monkeypatch.setattr(native, "available", lambda: False)
    ann, dets = _coco_dataset(tmp_path, seed)
    ev, got = _coco_stats(pce, COCOGt(ann), dets)
    jev, want = _coco_stats(jce, JaxCOCOGt(ann), dets)
    assert got.shape == (12,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    for k in ("precision", "recall", "scores"):
        np.testing.assert_allclose(ev.eval[k], jev.eval[k], rtol=0,
                                   atol=1e-12)
    _, got = _coco_stats(pce, COCOGt(ann), dets, class_index=[0, 2, 4])
    _, want = _coco_stats(jce, JaxCOCOGt(ann), dets, class_index=[0, 2, 4])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_coco_inner_loops_match_ait_tpu(monkeypatch):
    rng = np.random.RandomState(2)
    dt, gt = rng.rand(20, 4) * 50, rng.rand(10, 4) * 50
    crowd = (rng.rand(10) < 0.3).astype(np.uint8)
    ious = rng.rand(15, 6)
    ious[3, :] = 0.7                      # exact ties: last argmax wins
    ious[7, 2] = ious[7, 4] = 0.9
    ious[10, :] = 0.0
    gt_ig = np.sort((rng.rand(6) < 0.3).astype(np.uint8))
    crowd6 = (rng.rand(6) < 0.3).astype(np.uint8)
    thrs = np.linspace(0.5, 0.95, 10)
    for jax_native in (True, False):
        if not jax_native:
            monkeypatch.setattr(native, "available", lambda: False)
        np.testing.assert_allclose(pce.bbox_iou_xywh(dt, gt, crowd),
                                   jce.bbox_iou_xywh(dt, gt, crowd),
                                   rtol=1e-12)
        got = pce.greedy_match(ious, gt_ig, crowd6, thrs)
        want = jce.greedy_match(ious, gt_ig, crowd6, thrs)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(np.asarray(got[1], bool),
                                      np.asarray(want[1], bool))
    assert pce.bbox_iou_xywh(dt[:0], gt, crowd).shape == (0, 10)


def test_dets_to_coco_results_equal():
    rng = np.random.RandomState(3)
    all_boxes = {c: {r: np.concatenate([rng.rand(3, 4) * 50,
                                        rng.rand(3, 1)], 1)
                     for r in range(3)} for c in (1, 2)}
    ids, cats = {0: 42, 1: 43, 2: 44}, {1: 7, 2: 9}
    assert pce.dets_to_coco_results(all_boxes, ids, cats) == \
        jce.dets_to_coco_results(all_boxes, ids, cats)


# ---------------------------------------------------------- predictor

def _pairs():
    rng = np.random.RandomState(0)
    image = rng.randint(0, 256, (120, 160, 3)).astype(np.uint8)
    wide = rng.randint(0, 256, (90, 200, 3)).astype(np.uint8)
    grey = rng.randint(0, 256, (140, 100)).astype(np.uint8)
    qimg = rng.randint(0, 256, (200, 180, 3)).astype(np.uint8)
    return [(image, qimg, (20, 20, 120, 140)), (wide, qimg, (5, 5, 60, 60)),
            (grey, image, (10.5, 30.2, 90.7, 100.1))]


@pytest.mark.parametrize("uint8", [True, False])
def test_prep_pair_matches_ait_tpu(uint8):
    cfg = harness.port_config(harness.flagship()[0])
    cfg = cfg.replace(tpu=dataclasses.replace(cfg.tpu, input_uint8=uint8))
    jcfg = harness.flagship()[0]
    jcfg = jcfg.replace(tpu=dataclasses.replace(jcfg.tpu, input_uint8=uint8))
    port = types.SimpleNamespace(cfg=cfg)
    jax_side = types.SimpleNamespace(cfg=jcfg)
    for pair in _pairs():
        got = OneShotPredictor._prep_pair(port, *pair)
        want = JaxPredictor._prep_pair(jax_side, *pair)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
        if uint8:
            assert np.abs(got[0].astype(np.int32) -
                          want[0].astype(np.int32)).max() <= 1
            assert np.abs(got[1].astype(np.int32) -
                          want[1].astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
            np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got[2], want[2])


def test_predict_batch_equals_predict_prepared():
    _, _, _, pcfg, pm = harness.flagship()
    cfg = pcfg.replace(
        tpu=dataclasses.replace(pcfg.tpu, image_size=(96, 128)),
        TEST=dataclasses.replace(pcfg.TEST, SCALES=(80,)))
    pred = OneShotPredictor(cfg, pm.state_dict(), device="cpu",
                            dtype=torch.float32)
    pairs = _pairs()
    got = pred.predict_batch(pairs)
    prepared = [pred._prep_pair(*p) for p in pairs]
    assert prepared[0][0].shape == (96, 128, 3)
    want = pred.predict_prepared(*(np.stack(x) for x in zip(*prepared)))
    assert len(got) == len(want) == 3
    for g, w, (image, _, _) in zip(got, want, pairs):
        np.testing.assert_array_equal(g, w)
        assert g.ndim == 2 and g.shape[1] == 5 and np.isfinite(g).all()
        assert (g[:, 2] <= image.shape[1]).all()
        assert (g[:, 3] <= image.shape[0]).all()
    # one pair alone: the batch of 1 that predict_prepared gets for it
    np.testing.assert_array_equal(
        pred.predict(*pairs[1]),
        pred.predict_prepared(*(x[None] for x in prepared[1]))[0])
