"""The port's data layer (ait_tpu_torch/data: voc, coco, records, loader)
against ait_tpu's on the fixtures of tests/fixtures.py.

Per item, the port's `train_item`, `test_item` and `fused_item` against
ait_tpu's per-item methods (which take the cv2 path), same seed: metadata
(im_info, gt_boxes, num_boxes, pair_index, record_index, category)
bit-equal, uint8 pixels within 1 LSB (the resize is cv2's; measured
bit-equal), float32 pixels within 1e-5.
Epochs against ait_tpu's epochs (its native C++ path when built): the same
batches and metadata.  Plus the cases of test_data_voc.py,
test_wide_bucket.py, test_portrait_bucket.py, test_coco_dataset.py and
test_uint8_pipeline.py but those that run the reference implementation's
own code, and the record cache, which never reads the JAX package's
pickle.
"""

import dataclasses
import json
import os
import pickle
import random
import subprocess
import sys

import imageio.v2 as imageio
import numpy as np
import pytest

from ait_tpu.config import Config as JaxConfig
from ait_tpu.data import OneShotLoader as JaxLoader
from ait_tpu.data import coco as jcoco
from ait_tpu.data import voc as jvoc
from ait_tpu.data.records import DatasetView as JaxView
from ait_tpu.data.records import ImageRecord as JaxRecord
from ait_tpu.data.records import QueryExemplar as JaxExemplar
from ait_tpu_torch.config import Config
from ait_tpu_torch.data import OneShotLoader
from ait_tpu_torch.data import coco, loader as ploader, voc
from ait_tpu_torch.data.records import DatasetView, ImageRecord, QueryExemplar

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from fixtures import (make_coco_dataset, make_coco_devkit,  # noqa: E402
                      make_voc_devkit)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C2I = {c: i for i, c in enumerate(voc.VOC_CLASSES)}


def _same_item(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k in ("image", "query") and w.dtype == np.uint8:
            assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() \
                <= 1, k
        elif k in ("image", "query"):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.fixture(scope="module")
def voc_devkit(tmp_path_factory):
    return make_voc_devkit(str(tmp_path_factory.mktemp("VOCdevkit2007")))


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    return make_coco_devkit(str(tmp_path_factory.mktemp("coco_sys")))


def _voc_pair(devkit, seen):
    return (voc.filter_seen(voc.load_voc(devkit, "2007", "test"), seen),
            jvoc.filter_seen(jvoc.load_voc(devkit, "2007", "test"), seen))


def _jax_cfg(cfg=None):
    """ait_tpu's Config with the values of a port Config."""
    cfg = cfg or Config()

    def rebuild(template, values):
        kw = {}
        for f in dataclasses.fields(template):
            cur = getattr(template, f.name)
            v = values[f.name]
            kw[f.name] = rebuild(cur, v) if dataclasses.is_dataclass(cur) \
                else v
        return dataclasses.replace(template, **kw)

    return rebuild(JaxConfig(), dataclasses.asdict(cfg))


# ------------------------------------------------------------ per item

@pytest.mark.parametrize("uint8", [True, False])
def test_voc_items_match_ait_tpu(voc_devkit, uint8):
    cfg = Config()
    if not uint8:
        cfg = cfg.replace(tpu=dataclasses.replace(cfg.tpu, input_uint8=False))
    pv, jv = _voc_pair(voc_devkit, 1)
    pl = OneShotLoader(pv, cfg, training=True, seed=0)
    jl = JaxLoader(jv, _jax_cfg(cfg), training=True, seed=0)
    assert len(pl) == len(jl) == 6          # 3 images + their flips
    for i in range(len(pl)):
        _same_item(pl.train_item(i), jl.train_item(i))

    pv, jv = _voc_pair(voc_devkit, 2)
    pl = OneShotLoader(pv, cfg, training=False)
    jl = JaxLoader(jv, _jax_cfg(cfg), training=False)
    assert pl.pairs == jl.pairs
    for pos in (0, 1):
        pl.query_position = jl.query_position = pos
        for i in range(len(pl)):
            _same_item(pl.test_item(i), jl.test_item(i))


def test_voc_fused_items_match_ait_tpu(voc_devkit):
    pv, jv = _voc_pair(voc_devkit, 2)
    pl = OneShotLoader(pv, Config(), training=False)
    jl = JaxLoader(jv, JaxConfig(), training=False)
    for i in range(len(pl)):
        got, want = pl.fused_item(i, 3), jl.fused_item(i, 3)
        assert got["query"].shape == (3, 128, 128, 3)
        _same_item(got, want)


@pytest.mark.parametrize("use_all_gt", [True, False])
def test_coco_items_match_ait_tpu(coco_root, use_all_gt):
    data = os.path.join(coco_root, "coco")
    cfg = Config()
    cfg = cfg.replace(TRAIN=dataclasses.replace(cfg.TRAIN,
                                                USE_ALL_GT=use_all_gt))
    pv = coco.filter_seen(coco.load_coco(data, "2017", "val"), 2, 1)
    jv = jcoco.filter_seen(jcoco.load_coco(data, "2017", "val"), 2, 1)
    pl = OneShotLoader(pv, cfg, training=True, seed=5)
    jl = JaxLoader(jv, _jax_cfg(cfg), training=True, seed=5)
    for i in range(len(pl)):
        _same_item(pl.train_item(i), jl.train_item(i))

    pv = coco.filter_seen(coco.load_coco(data, "2017", "val"), 2, 1)
    jv = jcoco.filter_seen(jcoco.load_coco(data, "2017", "val"), 2, 1)
    pl = OneShotLoader(pv, cfg, training=False)
    jl = JaxLoader(jv, _jax_cfg(cfg), training=False)
    assert pl.pairs == jl.pairs and len(pl.pairs) > 0
    for i in range(len(pl)):
        _same_item(pl.test_item(i), jl.test_item(i))


def test_coco_dataset_items_match_ait_tpu(tmp_path):
    data = make_coco_dataset(str(tmp_path))
    pv = coco.filter_seen(coco.load_coco(data, "2017", "train"), 3, 0)
    jv = jcoco.filter_seen(jcoco.load_coco(data, "2017", "train"), 3, 0)
    pl = OneShotLoader(pv, Config(), training=True, seed=2)
    jl = JaxLoader(jv, JaxConfig(), training=True, seed=2)
    for i in range(len(pl)):
        _same_item(pl.train_item(i), jl.train_item(i))


# -------------------------------------------------------------- epochs

@pytest.mark.parametrize("training", [True, False])
def test_epochs_match_ait_tpu(voc_devkit, training):
    """The same batches in the same order, metadata bit-equal to
    ait_tpu's epoch; each batch's pixels those of the port's own items."""
    seen = 1 if training else 2
    pv, jv = _voc_pair(voc_devkit, seen)
    pl = OneShotLoader(pv, Config(), training=training, seed=0)
    jl = JaxLoader(jv, JaxConfig(), training=training, seed=0)
    if training:
        got = list(pl.train_epoch(2, num_workers=3))
        want = list(jl.train_epoch(2, num_workers=3))
    else:
        got = list(pl.test_epoch(2, num_workers=3))
        want = list(jl.test_epoch(2, num_workers=3))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype
            if k not in ("image", "query"):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    if not training:
        for batch in got:
            for j, pi in enumerate(batch["pair_index"]):
                item = pl.test_item(int(pi))
                np.testing.assert_array_equal(batch["image"][j],
                                              item["image"])
                np.testing.assert_array_equal(batch["query"][j],
                                              item["query"])


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("process_index", [0, 1])
def test_host_shards_match_ait_tpu(voc_devkit, training, process_index):
    """With process_count 2, each host's slice of every global batch has
    ait_tpu's metadata for the same host."""
    pv, jv = _voc_pair(voc_devkit, 1 if training else 2)
    kw = dict(training=training, seed=0, process_index=process_index,
              process_count=2)
    pl = OneShotLoader(pv, Config(), **kw)
    jl = JaxLoader(jv, JaxConfig(), **kw)
    epoch = "train_epoch" if training else "test_epoch"
    got = list(getattr(pl, epoch)(2, num_workers=2))
    want = list(getattr(jl, epoch)(2, num_workers=2))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["image"].shape[0] == 1
        for k in g:
            if k not in ("image", "query"):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_train_epoch_draws_do_not_depend_on_threads(voc_devkit):
    """The train sampling is drawn in order before the threaded pixel
    work: any worker count gives the same batches."""
    runs = []
    for workers in (1, 4):
        pv, _ = _voc_pair(voc_devkit, 1)
        pl = OneShotLoader(pv, Config(), training=True, seed=3)
        runs.append([b for _, b in zip(range(3), pl.train_epoch(
            2, num_workers=workers))])
    for a, b in zip(*runs):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_epoch_stops_early_and_raises_worker_errors(voc_devkit):
    pv, _ = _voc_pair(voc_devkit, 2)
    pl = OneShotLoader(pv, Config(), training=False)
    it = pl.test_epoch(1, num_workers=2, prefetch=1)
    next(it)
    it.close()                       # joins the producer, does not hang

    def broken(path):
        raise OSError(f"cannot read {path}")

    bad = OneShotLoader(_voc_pair(voc_devkit, 2)[0], Config(),
                        training=False, imread=broken)
    with pytest.raises(OSError, match="cannot read"):
        next(bad.test_epoch(2, num_workers=2))


# ----------------------------------------------- test_data_voc.py cases

def test_load_and_parse(voc_devkit):
    view = voc.load_voc(voc_devkit, "2007", "test")
    assert len(view.records) == 5
    r0 = view.records[0]
    assert (r0.width, r0.height) == (100, 80)
    np.testing.assert_allclose(r0.boxes[0], [10, 10, 59, 69])
    assert r0.gt_classes[0] == C2I["cat"]
    assert len(view.cat_data[C2I["cow"]]) == 2
    assert len(view.cat_data[C2I["dog"]]) == 2
    jview = jvoc.load_voc(voc_devkit, "2007", "test")
    for a, b in zip(view.records, jview.records):
        assert (a.img_id, a.image_path, a.width, a.height) == \
            (b.img_id, b.image_path, b.width, b.height)
        for f in ("boxes", "gt_classes", "difficult"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert voc.split_classes(1) == jvoc.split_classes(1)
    assert voc.class_order(2) == jvoc.class_order(2)


def test_filter_seen(voc_devkit):
    view = voc.filter_seen(voc.load_voc(voc_devkit, "2007", "test"), seen=2)
    assert len(view.records) == 4
    assert set(view.allowed_classes) == {C2I[c] for c in voc.UNSEEN_ORDER}
    with pytest.raises(ValueError):
        voc.split_classes(4)


def test_train_loader_batch(voc_devkit):
    cfg = Config()
    view = voc.filter_seen(voc.load_voc(voc_devkit, "2007", "test"), seen=1)
    loader = OneShotLoader(view, cfg, training=True, seed=0)
    batch = next(loader.train_epoch(4, num_workers=2))
    h, w = cfg.tpu.image_size
    assert batch["image"].shape == (4, h // 2, w // 2, 12)
    assert batch["query"].shape == (4, 128, 128, 3)
    assert batch["gt_boxes"].shape == (4, cfg.MAX_NUM_GT_BOXES, 5)
    for i in range(4):
        n = int(batch["num_boxes"][i])
        assert n >= 1
        labels = batch["gt_boxes"][i, :n, 4]
        assert set(np.unique(labels)) <= {0.0, 1.0} and labels.max() == 1.0
        ih, iw = batch["im_info"][i, 0], batch["im_info"][i, 1]
        assert batch["gt_boxes"][i, :n, 2].max() <= iw + 1e-3
        assert batch["gt_boxes"][i, :n, 3].max() <= ih + 1e-3


def test_test_loader_deterministic_shots(voc_devkit):
    view = voc.filter_seen(voc.load_voc(voc_devkit, "2007", "test"), seen=2)
    loader = OneShotLoader(view, Config(), training=False)
    assert len(loader.pairs) == 5
    np.testing.assert_array_equal(loader.test_item(0)["query"],
                                  loader.test_item(0)["query"])
    loader.query_position = 1
    q1 = loader.test_item(1)["query"]
    loader.query_position = 0
    assert not np.array_equal(q1, loader.test_item(1)["query"])


def test_shot_order_matches_global_seed_sequence():
    for img_id in (0, 1, 7, 123456, 2**31 - 1):
        for n in (1, 2, 5, 30):
            want = list(range(n))
            random.seed(img_id)
            random.shuffle(want)
            assert ploader._shot_order(img_id, n) == want, (img_id, n)


# ------------------------------------------ bucket cases (wide, portrait)

def _view(tmp_path, dims, port=True):
    R, E, V = (ImageRecord, QueryExemplar, DatasetView) if port else \
        (JaxRecord, JaxExemplar, JaxView)
    recs, cat_data = [], {1: []}
    for i, (h, w) in enumerate(dims):
        path = str(tmp_path / f"im{i}_{h}x{w}.png")
        if not os.path.exists(path):
            imageio.imwrite(path, np.random.RandomState(i).randint(
                0, 255, (h, w, 3), np.uint8))
        box = np.array([[4.0, 4.0, w - 5.0, h - 5.0]], np.float32)
        recs.append(R(i, path, w, h, box, np.array([1], np.int32),
                      np.zeros(1, np.int32)))
        cat_data[1].append(E(path, box[0]))
    view = V("wide", ("__background__", "a"), recs, cat_data)
    view.allowed_classes = [1]
    return view


def _bucket_cfg(wide):
    cfg = Config()
    return cfg.replace(
        tpu=dataclasses.replace(cfg.tpu, image_size=(128, 160),
                                wide_buckets=wide, portrait_bucket=True),
        TRAIN=dataclasses.replace(cfg.TRAIN, SCALES=(100,)),
        TEST=dataclasses.replace(cfg.TEST, SCALES=(100,)),
        MAX_NUM_GT_BOXES=4)


@pytest.mark.parametrize("dims,wide,canvas", [
    ((100, 200), ((128, 256),), (128, 256)),     # wide keeps the scale
    ((100, 200), (), (128, 160)),                 # no bucket: capped
    ((200, 100), ((128, 256),), (256, 128)),      # portrait transpose
    ((100, 200), ((608, 1216),), (128, 160)),     # other height: ignored
    ((100, 300), ((128, 256),), (128, 256)),      # beyond: the widest
    ((100, 120), ((128, 256),), (128, 160)),
])
def test_canvas_buckets(tmp_path, dims, wide, canvas):
    cfg = _bucket_cfg(wide)
    pl = OneShotLoader(_view(tmp_path, [dims]), cfg, training=False)
    jl = JaxLoader(_view(tmp_path, [dims], port=False), _jax_cfg(cfg),
                   training=False)
    assert pl._canvas_for(pl.view.records[0]) == canvas
    assert jl._canvas_for(jl.view.records[0]) == canvas
    batch = next(pl.test_epoch(1, num_workers=1))
    assert batch["image"].shape[1:] == (canvas[0] // 2, canvas[1] // 2, 12)
    _same_item(pl.test_item(0), jl.test_item(0))


def test_wide_image_keeps_reference_scale(tmp_path):
    loader = OneShotLoader(_view(tmp_path, [(100, 200)]),
                           _bucket_cfg(((128, 256),)), training=False)
    h, w, scale = next(loader.test_epoch(1, num_workers=1))["im_info"][0]
    assert scale == 1.0 and (h, w) == (100, 200)
    capped = OneShotLoader(_view(tmp_path, [(100, 200)]), _bucket_cfg(()),
                           training=False)
    info = next(capped.test_epoch(1, num_workers=1))["im_info"][0]
    assert abs(info[2] - 0.8) < 1e-6
    extreme = OneShotLoader(_view(tmp_path, [(100, 300)]),
                            _bucket_cfg(((128, 256),)), training=False)
    info = next(extreme.test_epoch(1, num_workers=1))["im_info"][0]
    assert abs(info[2] - 256.0 / 300.0) < 1e-6


def test_batches_group_by_canvas(tmp_path):
    dims = [(100, 120), (100, 210), (100, 115), (100, 205), (210, 100),
            (120, 100)]
    loader = OneShotLoader(_view(tmp_path, dims), _bucket_cfg(((128, 256),)),
                           training=False)
    seen, shapes = [], set()
    for batch in loader.test_epoch(2, num_workers=1):
        shapes.add(batch["image"].shape[1:3])
        seen.extend(batch["pair_index"].tolist())
    assert set(seen) == set(range(len(dims)))
    assert shapes == {(64, 80), (64, 128), (128, 64), (80, 64)}
    train = OneShotLoader(_view(tmp_path, dims), _bucket_cfg(((128, 256),)),
                          training=True, seed=1)
    jtrain = JaxLoader(_view(tmp_path, dims, port=False),
                       _jax_cfg(_bucket_cfg(((128, 256),))), training=True,
                       seed=1)
    got = list(train.train_epoch(2, num_workers=2))
    want = list(jtrain.train_epoch(2, num_workers=2))
    assert [b["image"].shape for b in got] == [b["image"].shape
                                               for b in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["gt_boxes"], w["gt_boxes"])
        np.testing.assert_array_equal(g["im_info"], w["im_info"])


PORTRAIT_FIXTURE = [
    ("000001", 100, 80, [("cat", 10, 10, 60, 70, 0)]),
    ("000002", 80, 160, [("cow", 5, 5, 50, 100, 0)]),   # tall
    ("000003", 120, 90, [("sheep", 12, 15, 70, 80, 0)]),
    ("000004", 70, 150, [("cat", 8, 8, 55, 120, 0)]),   # tall
]


def _portrait_view(tmp_path):
    devkit = make_voc_devkit(str(tmp_path / "VOCdevkit2007"),
                             fixture=PORTRAIT_FIXTURE)
    return voc.filter_seen(voc.load_voc(devkit, "2007", "test"), 2)


def _no_wide(cfg, **kw):
    return cfg.replace(tpu=dataclasses.replace(cfg.tpu, wide_buckets=(),
                                               **kw))


def test_portrait_canvas_and_resolution(tmp_path):
    loader = OneShotLoader(_portrait_view(tmp_path), _no_wide(Config()),
                           training=False)
    shapes, infos = set(), {}
    for batch in loader.test_epoch(2, num_workers=1):
        shapes.add(batch["image"].shape[1:3])
        for i, pi in enumerate(batch["pair_index"]):
            infos[int(pi)] = batch["im_info"][i]
    assert shapes == {(304, 400), (400, 304)}
    tall = [i for i, (r, _) in enumerate(loader.pairs) if r == 1][0]
    assert abs(float(infos[tall][2]) - 800.0 / 160.0) < 1e-6


def test_landscape_only_without_bucket(tmp_path):
    loader = OneShotLoader(_portrait_view(tmp_path),
                           _no_wide(Config(), portrait_bucket=False),
                           training=False)
    assert {b["image"].shape[1:3] for b in loader.test_epoch(
        2, num_workers=1)} == {(304, 400)}


def test_train_batches_homogeneous(tmp_path):
    view = _portrait_view(tmp_path)
    loader = OneShotLoader(view, _no_wide(Config()), training=True, seed=0)
    shapes = [b["image"].shape[1:3]
              for b in loader.train_epoch(2, num_workers=1)]
    assert set(shapes) == {(304, 400), (400, 304)}
    assert len(shapes) >= len(view.records) // 2


# --------------------------------------------- test_coco_dataset.py cases

def _write_coco(root):
    data = root / "coco"
    (data / "annotations").mkdir(parents=True)
    img_dir = data / "images" / "train2017"
    img_dir.mkdir(parents=True)
    rng = np.random.RandomState(0)
    images = []
    for i in range(1, 4):
        imageio.imwrite(str(img_dir / f"{i:012d}.jpg"),
                        (rng.rand(60, 80, 3) * 255).astype(np.uint8))
        images.append({"id": i, "width": 80, "height": 60,
                       "file_name": f"{i:012d}.jpg"})
    anns = [
        {"id": 1, "image_id": 1, "category_id": 1,
         "bbox": [5, 5, 30, 20], "area": 600, "iscrowd": 0},
        {"id": 2, "image_id": 1, "category_id": 3,
         "bbox": [70, 50, 30, 30], "area": 900, "iscrowd": 0},
        {"id": 3, "image_id": 2, "category_id": 1,
         "bbox": [10, 10, 5, 5], "area": 0, "iscrowd": 0},
        {"id": 4, "image_id": 2, "category_id": 5,
         "bbox": [2, 2, 40, 30], "area": 1200, "iscrowd": 1},
        {"id": 5, "image_id": 3, "category_id": 7,
         "bbox": [8, 6, 25, 25], "area": 625, "iscrowd": 0},
    ]
    doc = {"images": images, "annotations": anns,
           "categories": [{"id": c, "name": f"c{c}"} for c in (1, 3, 5, 7)]}
    (data / "annotations" / "instances_train2017.json").write_text(
        json.dumps(doc))
    return str(data)


def test_coco_sanitize_and_crowd(tmp_path):
    data = _write_coco(tmp_path)
    view = coco.load_coco(data, "2017", "train")
    assert len(view.records) == 3
    np.testing.assert_allclose(view.records[0].boxes[1], [70, 50, 79, 59])
    r2 = view.records[1]
    assert len(r2.boxes) == 1 and r2.difficult[0] == 1
    assert len(view.cat_data[3]) == 0 and len(view.cat_data[1]) == 1
    assert isinstance(view.coco_gt, coco.COCOGt)
    assert len(view.coco_gt.annotations) == 5
    jview = jcoco.load_coco(data, "2017", "train")
    assert view.classes == jview.classes
    for a, b in zip(view.records, jview.records):
        for f in ("boxes", "gt_classes", "difficult"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_coco_reference_pkl_gating(tmp_path):
    data = _write_coco(tmp_path)
    ref_file = tmp_path / "ref.pkl"
    ref_file.write_bytes(pickle.dumps({1: {0: "something"}}))
    view = coco.load_coco(data, "2017", "train",
                          reference_file=str(ref_file))
    assert len(view.cat_data[1]) == 1 and len(view.cat_data[4]) == 0
    # the reference file is data: a pickle that names a class is refused
    evil = tmp_path / "evil.pkl"
    evil.write_bytes(pickle.dumps({1: {0: JaxExemplar("x", np.zeros(4))}}))
    with pytest.raises(pickle.UnpicklingError, match="not data"):
        coco.load_coco(data, "2017", "train", reference_file=str(evil))


def test_coco_group_splits(tmp_path):
    s, u = coco.split_classes(1, 2), coco.split_classes(2, 2)
    assert 2 not in s and 6 not in s and 1 in s and 80 in s
    assert set(u) == {c for c in range(1, 81) if c % 4 == 2}
    assert set(s) | set(u) == set(range(1, 81))
    assert s == jcoco.split_classes(1, 2)
    view = coco.load_coco(_write_coco(tmp_path), "2017", "train")
    assert coco.filter_seen(view, seen=2, group=1).allowed_classes == [1]


# ------------------------------------------------------------ the cache

def _same_views(a, b):
    assert a.classes == b.classes and len(a.records) == len(b.records)
    for r1, r2 in zip(a.records, b.records):
        assert (r1.img_id, r1.image_path, r1.width, r1.height,
                r1.flipped) == (r2.img_id, r2.image_path, r2.width,
                                r2.height, r2.flipped)
        for f in ("boxes", "gt_classes", "difficult"):
            x, y = getattr(r1, f), getattr(r2, f)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    assert sorted(a.cat_data) == sorted(b.cat_data)
    for c in a.cat_data:
        assert [e.image_path for e in a.cat_data[c]] == \
            [e.image_path for e in b.cat_data[c]]
        for e1, e2 in zip(a.cat_data[c], b.cat_data[c]):
            assert e1.box.dtype == e2.box.dtype
            np.testing.assert_array_equal(e1.box, e2.box)


def test_coco_record_cache_roundtrip(tmp_path):
    data = _write_coco(tmp_path)
    cache = tmp_path / "cache"
    v1 = coco.load_coco(data, "2017", "train", cache_dir=str(cache))
    assert os.listdir(cache) == ["coco_2017_train_records.json"]
    v2 = coco.load_coco(data, "2017", "train", cache_dir=str(cache))
    assert v2._coco_gt is None
    _same_views(v1, v2)
    assert isinstance(v2.coco_gt, coco.COCOGt)
    assert len(v2.coco_gt.annotations) == len(v1.coco_gt.annotations)


def test_voc_record_cache_roundtrip(voc_devkit, tmp_path):
    v1 = voc.load_voc(voc_devkit, "2007", "test", cache_dir=str(tmp_path))
    v2 = voc.load_voc(voc_devkit, "2007", "test", cache_dir=str(tmp_path))
    _same_views(v1, v2)


def test_cache_never_reads_the_jax_pickle(voc_devkit, tmp_path):
    """A cache_dir that holds ait_tpu's `{name}_records.pkl` (pickled
    ait_tpu classes): the port reads the annotations, writes its own JSON
    cache beside it, and loads no ait_tpu module (fresh interpreter)."""
    cache = str(tmp_path)
    jvoc.load_voc(voc_devkit, "2007", "test", cache_dir=cache)
    assert os.listdir(cache) == ["voc_2007_test_records.pkl"]
    code = ("import sys; from ait_tpu_torch.data.voc import load_voc; "
            f"v = load_voc({voc_devkit!r}, '2007', 'test', "
            f"cache_dir={cache!r}); "
            f"v = load_voc({voc_devkit!r}, '2007', 'test', "
            f"cache_dir={cache!r}); assert len(v.records) == 5; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('ait_tpu', 'jax')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
    assert sorted(os.listdir(cache)) == ["voc_2007_test_records.json",
                                         "voc_2007_test_records.pkl"]


# ------------------------------------------------------------- imread

def test_imread_injection(voc_devkit, monkeypatch):
    """Images come through `imread`: served from arrays in memory they give
    the same items; without imageio the default reader raises an error
    that names `imread=`, and nothing is substituted."""
    pv, _ = _voc_pair(voc_devkit, 2)
    arrays = {r.image_path: imageio.imread(r.image_path)
              for r in pv.records}
    calls = []

    def from_memory(path):
        calls.append(path)
        return arrays[path]

    a = OneShotLoader(pv, Config(), training=False, imread=from_memory)
    b = OneShotLoader(_voc_pair(voc_devkit, 2)[0], Config(), training=False)
    _same_item(a.test_item(0), b.test_item(0))
    assert calls

    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    with pytest.raises(ImportError, match="imread="):
        b.test_item(0)


# ------------------------------------------- test_uint8_pipeline.py case

def test_loader_uint8_vs_float_paths(voc_devkit):
    import torch

    from ait_tpu_torch.data.transforms import space_to_depth
    from ait_tpu_torch.models.detector import _to_model_input

    cfg8 = Config()
    cfgf = cfg8.replace(tpu=dataclasses.replace(cfg8.tpu, input_uint8=False))
    l8 = OneShotLoader(_voc_pair(voc_devkit, 1)[0], cfg8, training=False)
    lf = OneShotLoader(_voc_pair(voc_devkit, 1)[0], cfgf, training=False)
    i8, ifl = l8.test_item(0), lf.test_item(0)
    assert i8["image"].dtype == np.uint8 and ifl["image"].dtype == np.float32
    assert l8.host_s2d and not lf.host_s2d and i8["image"].shape[-1] == 12
    dev = _to_model_input(torch.from_numpy(i8["image"]), torch.float32)
    np.testing.assert_allclose(dev.numpy(), space_to_depth(ifl["image"]),
                               atol=1.2 / 255 / 0.225)
    np.testing.assert_array_equal(i8["im_info"], ifl["im_info"])
    q = _to_model_input(torch.from_numpy(i8["query"]), torch.float32)
    np.testing.assert_allclose(q.numpy(), ifl["query"], atol=1e-5)
