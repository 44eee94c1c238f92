"""PASCAL VOC dataset for one-shot detection (counterpart of
ait_tpu/data/voc.py).

Pinned to lib/datasets/pascal_voc.py:
  * XML annotation parse with 0-based boxes: x2 = xmax - 1, y2 = ymax - 1
    (`:263-266`); difficult objects are KEPT in the training gt (`:241-248`
    commented out) but excluded from AP (voc_eval.py);
  * every annotated box (any class) feeds the `cat_data` query pool
    (`:278-282`);
  * one-shot class splits (`filter`, `:453-485`): seen=1 the 16 seen classes,
    seen=2 the 4 unseen ({cow, sheep, cat, aeroplane}), seen=3 all 20; images
    containing no allowed class are dropped;
  * a record cache in `cache_dir` (records.write_cache: JSON, never a
    pickle).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import List, Optional

import numpy as np

from ait_tpu_torch.data.records import (DatasetView, ImageRecord,
                                        QueryExemplar, cache_path,
                                        read_cache, write_cache)

VOC_CLASSES = (
    "__background__",
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)

# evaluation table order per split (pascal_voc.py:457-468)
SEEN_ORDER = (
    "pottedplant", "sofa", "tvmonitor", "car", "bottle", "boat", "chair",
    "person", "bus", "train", "horse", "bicycle", "dog", "bird", "motorbike",
    "diningtable",
)
UNSEEN_ORDER = ("cow", "sheep", "cat", "aeroplane")

_C2I = {c: i for i, c in enumerate(VOC_CLASSES)}


def split_classes(seen: int) -> List[int]:
    if seen == 1:
        return [_C2I[c] for c in SEEN_ORDER]
    if seen == 2:
        return [_C2I[c] for c in UNSEEN_ORDER]
    if seen == 3:
        return list(range(1, 21))
    raise ValueError(f"seen must be 1|2|3, got {seen}")


def class_order(seen: int) -> List[str]:
    return list(SEEN_ORDER if seen == 1 else
                UNSEEN_ORDER if seen == 2 else VOC_CLASSES[1:])


def parse_annotation(xml_path: str, image_path: str, img_id):
    tree = ET.parse(xml_path)
    size = tree.find("size")
    width = int(size.find("width").text)
    height = int(size.find("height").text)
    objs = tree.findall("object")
    boxes = np.zeros((len(objs), 4), np.float32)
    classes = np.zeros(len(objs), np.int32)
    difficult = np.zeros(len(objs), np.int32)
    exemplars = []
    for i, obj in enumerate(objs):
        bb = obj.find("bndbox")
        x1 = float(bb.find("xmin").text)
        y1 = float(bb.find("ymin").text)
        x2 = float(bb.find("xmax").text) - 1
        y2 = float(bb.find("ymax").text) - 1
        d = obj.find("difficult")
        cls = _C2I[obj.find("name").text.lower().strip()]
        boxes[i] = [x1, y1, x2, y2]
        classes[i] = cls
        difficult[i] = 0 if d is None else int(d.text)
        exemplars.append((cls, QueryExemplar(image_path,
                                             np.array([x1, y1, x2, y2]))))
    rec = ImageRecord(img_id, image_path, width, height, boxes, classes,
                      difficult)
    return rec, exemplars


def load_voc(devkit_path: str, year: str, image_set: str,
             cache_dir: Optional[str] = None) -> DatasetView:
    """devkit_path/VOC{year}/{Annotations,JPEGImages,ImageSets/Main}."""
    data_path = os.path.join(devkit_path, f"VOC{year}")
    name = f"voc_{year}_{image_set}"
    cache_file = cache_path(cache_dir, name)
    if cache_file and os.path.exists(cache_file):
        _, records, cat_data = read_cache(cache_file)
        return DatasetView(name, VOC_CLASSES, records, cat_data)

    setfile = os.path.join(data_path, "ImageSets", "Main",
                           image_set + ".txt")
    with open(setfile) as f:
        index = [x.strip() for x in f if x.strip()]

    records = []
    cat_data = {i: [] for i in range(len(VOC_CLASSES))}
    for i, idx in enumerate(index):
        xml = os.path.join(data_path, "Annotations", idx + ".xml")
        img = os.path.join(data_path, "JPEGImages", idx + ".jpg")
        rec, exemplars = parse_annotation(xml, img, i)
        rec.img_id = i
        records.append(rec)
        for cls, ex in exemplars:
            cat_data[cls].append(ex)

    if cache_file:
        write_cache(cache_file, VOC_CLASSES, records, cat_data)
    return DatasetView(name, VOC_CLASSES, records, cat_data)


def filter_seen(view: DatasetView, seen: int) -> DatasetView:
    """Keep images containing >=1 allowed class (pascal_voc.py:473-485)."""
    allowed = split_classes(seen)
    aset = set(allowed)
    view.allowed_classes = allowed
    view.records = [r for r in view.records
                    if any(int(c) in aset for c in r.gt_classes)]
    return view
