"""Dataset-agnostic record types of the data layer (counterpart of
ait_tpu/data/records.py).

The reference passes around `roidb` dicts ({boxes, gt_classes, flipped,
width, height, image, img_id, ...}, roi_data_layer/roidb.py:15-48) plus a
per-class `cat_data` query-exemplar pool (pascal_voc.py:94-98,278-282).
These are the typed equivalents.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, List

import numpy as np


@dataclass
class ImageRecord:
    img_id: Any
    image_path: str
    width: int
    height: int
    boxes: np.ndarray          # [N, 4] float32, x1,y1,x2,y2 (0-based)
    gt_classes: np.ndarray     # [N] int32 (dataset class indices, 0 = bg)
    difficult: np.ndarray      # [N] int32 (VOC 'difficult' flag; 0 for COCO)
    flipped: bool = False

    def flipped_copy(self) -> "ImageRecord":
        """Horizontal flip (imdb.append_flipped_images, imdb.py:114-129)."""
        boxes = self.boxes.copy()
        oldx1 = boxes[:, 0].copy()
        oldx2 = boxes[:, 2].copy()
        boxes[:, 0] = self.width - oldx2 - 1
        boxes[:, 2] = self.width - oldx1 - 1
        return dataclasses.replace(self, boxes=boxes, flipped=True)


@dataclass
class QueryExemplar:
    """One query crop candidate (an annotated gt box in some image)."""
    image_path: str
    box: np.ndarray            # [4] x1,y1,x2,y2


@dataclass
class DatasetView:
    """Everything the loader needs: records + query pools + class split."""
    name: str
    classes: tuple                      # ('__background__', ...)
    records: List[ImageRecord]
    cat_data: dict                      # class_ind -> [QueryExemplar]
    allowed_classes: List[int] = field(default_factory=list)
    # COCO only: gt index for the evaluator, built lazily from the
    # annotation json so record-cache hits skip the parse entirely
    _coco_gt: Any = field(default=None, repr=False)
    _coco_ann_file: Any = field(default=None, repr=False)

    @property
    def coco_gt(self):
        if self._coco_gt is None and self._coco_ann_file:
            from ait_tpu_torch.data.coco import COCOGt
            self._coco_gt = COCOGt(self._coco_ann_file)
        return self._coco_gt

    @coco_gt.setter
    def coco_gt(self, gt):
        self._coco_gt = gt

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    def append_flipped(self):
        self.records = self.records + [r.flipped_copy() for r in self.records]

    def filter_boxless(self):
        """Drop images without gt (roidb.py:76-89)."""
        self.records = [r for r in self.records if len(r.boxes)]

    def class_frequencies(self) -> dict:
        """Inverse-frequency sampling weights (roibatchLoader.py:365-383)."""
        counts = {c: 0 for c in self.allowed_classes}
        for r in self.records:
            for c in r.gt_classes:
                if int(c) in counts:
                    counts[int(c)] += 1
        inv = {c: 1.0 / max(n, 1) for c, n in counts.items()}
        total = sum(inv.values())
        return {c: v / total for c, v in inv.items()}


# ---------------------------------------------------------------- cache
# The loaders cache their parsed records as JSON (builtins only): reading
# the cache runs no code, and the JAX package's pickled cache
# (`{name}_records.pkl`) is never read.

def cache_path(cache_dir, name: str):
    return os.path.join(cache_dir, f"{name}_records.json") if cache_dir \
        else None


def _array(a) -> dict:
    a = np.asarray(a)
    return {"dtype": a.dtype.str, "shape": list(a.shape),
            "data": a.ravel().tolist()}


def _from_array(d) -> np.ndarray:
    return np.asarray(d["data"], np.dtype(d["dtype"])).reshape(d["shape"])


def write_cache(path: str, classes, records: List[ImageRecord],
                cat_data: dict) -> None:
    doc = {
        "classes": list(classes),
        "records": [{"img_id": r.img_id, "image_path": r.image_path,
                     "width": r.width, "height": r.height,
                     "boxes": _array(r.boxes),
                     "gt_classes": _array(r.gt_classes),
                     "difficult": _array(r.difficult),
                     "flipped": r.flipped} for r in records],
        "cat_data": {str(c): [[e.image_path, _array(e.box)] for e in exs]
                     for c, exs in cat_data.items()},
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # a name of this process's own: ranks that share a cache directory
    # write it at once, and each os.replace must find its own file
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)


def read_cache(path: str):
    """(classes, records, cat_data) of a cache that write_cache wrote."""
    with open(path) as f:
        doc = json.load(f)
    records = [ImageRecord(r["img_id"], r["image_path"], r["width"],
                           r["height"], _from_array(r["boxes"]),
                           _from_array(r["gt_classes"]),
                           _from_array(r["difficult"]), r["flipped"])
               for r in doc["records"]]
    cat_data = {int(c): [QueryExemplar(p, _from_array(b)) for p, b in exs]
                for c, exs in doc["cat_data"].items()}
    return tuple(doc["classes"]), records, cat_data
