"""MS-COCO dataset for one-shot detection (counterpart of
ait_tpu/data/coco.py) — direct JSON parse, no pycocotools.

Pinned to lib/datasets/coco.py:
  * bbox sanitize: clip to image, drop area<=0 / inverted boxes
    (`:200-209`: x2 = min(w-1, x1 + max(0, bw - 1)));
  * crowd objects KEPT in the roidb (`:231-236` marks overlaps=-1, but the
    live path has TRAIN.USE_ALL_GT=True so minibatch.py:39-41 includes them
    in the training gt anyway) — here `iscrowd` rides the record's
    `difficult` field as bookkeeping;
  * the `cat_data` query pool is gated by the "reference image" pickle of
    Mask-R-CNN-verified crops (`:91-99,194-216`, README §4) when present;
    without the file every sanitized non-crowd gt box is eligible
    (documented deviation — the pkl ships with the reference release);
  * 4-way class-group split (`filter`, `:420-459`): contiguous class index
    c in 1..80, group g: seen=1 keeps c%4 != g, seen=2 keeps c%4 == g,
    seen=3 all;
  * images without an allowed class are dropped.

The raw images/annotations/categories tables are kept on the view
(`coco_gt`) for the evaluator — COCO AP evaluates against the ORIGINAL
annotations, not the sanitized training boxes.  The record cache is JSON
(records.write_cache), never a pickle; the reference-image file, a pickle
of the reference's release, is read by an unpickler that builds builtins
and numpy arrays only.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import List, Optional

import numpy as np

from ait_tpu_torch.data.records import (DatasetView, ImageRecord,
                                        QueryExemplar, cache_path,
                                        read_cache, write_cache)


class _DataUnpickler(pickle.Unpickler):
    """Builds builtins and numpy arrays; refuses every other class."""

    _ALLOWED = {("numpy", "ndarray"), ("numpy", "dtype"),
                ("numpy.core.multiarray", "_reconstruct"),
                ("numpy._core.multiarray", "_reconstruct"),
                ("numpy.core.multiarray", "scalar"),
                ("numpy._core.multiarray", "scalar"),
                ("builtins", "set"), ("builtins", "frozenset"),
                ("collections", "OrderedDict")}

    def find_class(self, module, name):
        if (module, name) not in self._ALLOWED:
            raise pickle.UnpicklingError(
                f"{module}.{name} is not data: refused")
        return super().find_class(module, name)


def _read_data_pickle(path: str):
    with open(path, "rb") as f:
        return _DataUnpickler(f).load()


class COCOGt:
    """Minimal ground-truth index over a COCO instances json."""

    def __init__(self, ann_file: str):
        with open(ann_file) as f:
            doc = json.load(f)
        self.images = {im["id"]: im for im in doc["images"]}
        self.categories = sorted(doc.get("categories", []),
                                 key=lambda c: c["id"])
        self.cat_ids = [c["id"] for c in self.categories]
        self.cat_names = [c["name"] for c in self.categories]
        self.anns_by_image = {im_id: [] for im_id in self.images}
        self.annotations = doc.get("annotations", [])
        for ann in self.annotations:
            self.anns_by_image.setdefault(ann["image_id"], []).append(ann)
        # contiguous class ind (1..K) <-> coco cat id
        self.cat_id_to_class_ind = {cid: i + 1
                                    for i, cid in enumerate(self.cat_ids)}
        self.class_ind_to_cat_id = {i + 1: cid
                                    for i, cid in enumerate(self.cat_ids)}


def _image_file_name(im: dict, data_name: str) -> str:
    if "file_name" in im:
        return im["file_name"]
    # 2014/2015-era layouts prefix the set name; 2017 is the bare id
    if "2014" in data_name or "2015" in data_name:
        return f"COCO_{data_name}_{im['id']:012d}.jpg"
    return f"{im['id']:012d}.jpg"


def load_coco(data_path: str, year: str, image_set: str,
              cache_dir: Optional[str] = None,
              reference_file: Optional[str] = None) -> DatasetView:
    """data_path/{annotations/instances_<set><year>.json, images/<set><year>/}.

    minival2014 / valminusminival2014 are annotation subsets whose images
    live in val2014 (the reference's _view_map, lib/datasets/coco.py:75-86).
    """
    name = f"coco_{year}_{image_set}"
    view_map = {"minival2014": "val2014",
                "valminusminival2014": "val2014"}
    data_name = view_map.get(image_set + year, image_set + year)
    ann_file = os.path.join(data_path, "annotations",
                            f"instances_{image_set}{year}.json")

    # record cache (the reference pickles its roidb, coco.py:91-99); a hit
    # skips both the instances-json parse and the per-annotation loop —
    # the evaluator's gt index is rebuilt lazily only if eval needs it
    cache_file = cache_path(cache_dir, name)
    if cache_file and os.path.exists(cache_file):
        classes, records, cat_data = read_cache(cache_file)
        view = DatasetView(name, classes, records, cat_data)
        view._coco_ann_file = ann_file
        return view

    gt = COCOGt(ann_file)

    if reference_file is None:
        default_ref = os.path.join(
            data_path, "..", "coco_reference_image",
            f"coco_{data_name}_e2e_mask_rcnn_R_101_FPN_1x_caffe2.pkl")
        reference_file = default_ref if os.path.exists(default_ref) else None
    reference = None
    if reference_file and os.path.exists(reference_file):
        reference = _read_data_pickle(reference_file)

    classes = tuple(["__background__"] + gt.cat_names)
    records: List[ImageRecord] = []
    cat_data = {i: [] for i in range(len(classes))}

    for im_id in sorted(gt.images):
        im = gt.images[im_id]
        w, h = im["width"], im["height"]
        path = os.path.join(data_path, "images", data_name,
                            _image_file_name(im, data_name))
        boxes, cls, crowd = [], [], []
        # with a reference pkl, images absent from it contribute no query
        # crops (the reference indexes it unconditionally, coco.py:195)
        save_seq = (set(reference.get(im_id, {}).keys())
                    if reference is not None else None)
        for i, ann in enumerate(gt.anns_by_image.get(im_id, [])):
            bx, by, bw, bh = ann["bbox"]
            x1 = max(0.0, bx)
            y1 = max(0.0, by)
            x2 = min(w - 1.0, x1 + max(0.0, bw - 1))
            y2 = min(h - 1.0, y1 + max(0.0, bh - 1))
            if ann.get("area", bw * bh) <= 0 or x2 < x1 or y2 < y1:
                continue
            ci = gt.cat_id_to_class_ind[ann["category_id"]]
            boxes.append([x1, y1, x2, y2])
            cls.append(ci)
            crowd.append(int(ann.get("iscrowd", 0)))
            # with the reference pkl: follow it exactly; without: every
            # non-crowd sanitized box is an eligible query crop
            eligible = (i in save_seq if save_seq is not None
                        else not ann.get("iscrowd", 0))
            if eligible:
                cat_data[ci].append(
                    QueryExemplar(path, np.array([x1, y1, x2, y2])))
        n = len(boxes)
        rec = ImageRecord(
            img_id=im_id, image_path=path, width=w, height=h,
            boxes=np.asarray(boxes, np.float32).reshape(n, 4),
            gt_classes=np.asarray(cls, np.int32),
            # reuse `difficult` to carry iscrowd; under the default
            # TRAIN.USE_ALL_GT=True crowd boxes stay in the training gt like
            # the reference's (config.py:160-161, minibatch.py:38-44), and
            # the loader drops them only when that knob is False
            difficult=np.asarray(crowd, np.int32))
        records.append(rec)

    if cache_file:
        write_cache(cache_file, classes, records, cat_data)

    view = DatasetView(name, classes, records, cat_data)
    view._coco_ann_file = ann_file
    view.coco_gt = gt
    return view


def split_classes(seen: int, group: int, num_classes: int = 80) -> List[int]:
    """Contiguous class indices for a 4-way group split (coco.py:420-441)."""
    if seen == 1:
        return [c for c in range(1, num_classes + 1) if c % 4 != group]
    if seen == 2:
        return [c for c in range(1, num_classes + 1) if c % 4 == group]
    if seen == 3:
        return list(range(1, num_classes + 1))
    raise ValueError(f"seen must be 1|2|3, got {seen}")


def filter_seen(view: DatasetView, seen: int, group: int) -> DatasetView:
    allowed = split_classes(seen, group,
                            num_classes=len(view.classes) - 1)
    aset = set(allowed)
    view.allowed_classes = allowed
    view.records = [r for r in view.records
                    if any(int(c) in aset for c in r.gt_classes)]
    return view
