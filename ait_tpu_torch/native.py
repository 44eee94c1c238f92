"""ctypes bindings of the port's host C++ (counterpart of ait_tpu/native.py).

Two libraries, built with g++ at first use into `ait_tpu_torch/_build/`
(ops/_build.py; the JAX package's native/libait_native.so is never
loaded):

* `csrc/ait_loader.cpp`: a batch's target canvases and query crops on C++
  threads (`prep_targets`, `prep_queries`, `space_to_depth`), from images
  the caller has already read (the loader's `imread`): a table of pointers
  to HxWx3 uint8 arrays.  Its pixels are data/transforms.py's, bit for bit.
* `csrc/ait_native.cpp`: the COCO eval loops (`bbox_iou_xywh`,
  `greedy_match`) and a host NMS (`nms_xyxy`), in float64 with the same
  operations as the numpy versions.

The functions are called through `ctypes.CDLL`, which releases the
interpreter lock for the call, so the loader's C++ threads run beside the
step's Python.  `available()` builds both libraries at first use and
raises when a build fails: there is no quiet fallback.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Sequence

import numpy as np

from ait_tpu_torch.ops import _build

_i64, _i32, _dbl, _vp = (ctypes.c_int64, ctypes.c_int32, ctypes.c_double,
                         ctypes.c_void_p)
_LOADER_FUNCS = {
    "ail_prep_targets": [_i64, _vp, _vp, _vp, _i32, _i32, _i32, _vp, _i32,
                         _vp, _vp, _vp, _vp, _i32],
    "ail_prep_queries": [_i64, _vp, _vp, _vp, _vp, _i32, _vp, _vp, _i32],
    "ail_space_to_depth": [_i64, _i32, _i32, _vp, _vp, _i32]}
_NATIVE_FUNCS = {
    "ait_bbox_iou_xywh": [_i64, _vp, _i64, _vp, _vp, _vp],
    "ait_greedy_match": [_i64, _vp, _i64, _i64, _vp, _vp, _vp, _vp, _vp],
    "ait_nms_xyxy": [_i64, _vp, _dbl, _vp]}

_LOCK = threading.Lock()
_LIBS: dict = {}


def _libs():
    """(loader library, eval library), built and loaded at first use."""
    if not _LIBS:
        with _LOCK:
            if not _LIBS:
                _build.build_all(["ait_loader", "ait_native"])
                loader = _build.load("ait_loader", _LOADER_FUNCS)
                evals = _build.load("ait_native", _NATIVE_FUNCS)
                for name in _NATIVE_FUNCS:          # these return void
                    getattr(evals, name).restype = None
                _LIBS.update(loader=loader, evals=evals)
    return _LIBS["loader"], _LIBS["evals"]


def available() -> bool:
    """True once both libraries are built and loaded; a failed build
    raises (RuntimeError with the compiler's output)."""
    _libs()
    return True


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _image_table(images: Sequence[np.ndarray]):
    """(pointer table, [n, 2] int32 sizes, the contiguous arrays): the
    arrays must stay alive for the call, so the caller holds the third."""
    arrays = []
    for im in images:
        if im.dtype != np.uint8 or im.ndim != 3 or im.shape[2] != 3:
            raise ValueError("the native loader takes HxWx3 uint8 images, "
                             f"got {im.dtype} {im.shape}")
        arrays.append(np.ascontiguousarray(im))
    table = (ctypes.c_void_p * max(len(arrays), 1))(
        *[_ptr(a) for a in arrays])
    hw = np.array([a.shape[:2] for a in arrays], np.int32).reshape(-1, 2)
    return table, hw, arrays


def _raise_failed(status: np.ndarray, what: str, sizes) -> None:
    bad = np.nonzero(status)[0]
    if len(bad):
        raise ValueError(f"native {what}: items {bad.tolist()} resize to an "
                         f"empty image (sizes {[tuple(sizes[i]) for i in bad]})")


def prep_targets(images: Sequence[np.ndarray], flips, target_size: int,
                 canvas_hw, fill, n_threads: int = 8, s2d: bool = False):
    """A batch of target canvases: flip, shortest-side scale to
    target_size capped to the canvas, top-left on a canvas filled with
    `fill`.  Returns (canvases [N, H, W, 3] uint8, or [N, H/2, W/2, 12]
    with `s2d`; info [N, 3] float32 (scaled h, scaled w, scale); the
    scales [N] float64)."""
    loader, _ = _libs()
    table, hw, arrays = _image_table(images)
    n = len(arrays)
    ch, cw = int(canvas_hw[0]), int(canvas_hw[1])
    if s2d and (ch % 2 or cw % 2):
        raise ValueError(f"space-to-depth needs even canvas sides: {ch}x{cw}")
    out = (np.empty((n, ch // 2, cw // 2, 12), np.uint8) if s2d
           else np.empty((n, ch, cw, 3), np.uint8))
    info = np.empty((n, 3), np.float32)
    scales = np.empty(n, np.float64)
    status = np.zeros(n, np.uint8)
    flips = np.ascontiguousarray(flips, np.uint8)
    fill = np.ascontiguousarray(fill, np.uint8)
    if n:
        loader.ail_prep_targets(
            n, ctypes.cast(table, ctypes.c_void_p), _ptr(hw), _ptr(flips),
            int(target_size), ch, cw, _ptr(fill), int(bool(s2d)), _ptr(out),
            _ptr(info), _ptr(scales), _ptr(status), int(n_threads))
    del arrays
    _raise_failed(status, "prep_targets", hw)
    return out, info, scales


def _crop_window(shape, box):
    """The rows and columns (y0, y1, x0, x1) that transforms.crop_query
    cuts for `box`, as Python resolves its slices."""
    h, w = shape[:2]
    y0, y1, _ = slice(int(box[1]), int(box[3])).indices(h)
    x0, x1, _ = slice(int(box[0]), int(box[2])).indices(w)
    return y0, y1, x0, x1


def prep_queries(images: Sequence[np.ndarray], boxes, flips,
                 query_size: int, n_threads: int = 8) -> np.ndarray:
    """A batch of query crops: cut each box (x1, y1, x2, y2) out of its
    image, center-pad square, resize to query_size, flip where asked.
    Returns [N, query_size, query_size, 3] uint8."""
    loader, _ = _libs()
    table, hw, arrays = _image_table(images)
    n = len(arrays)
    crops = np.array([_crop_window(a.shape, b)
                      for a, b in zip(arrays, boxes)], np.int32).reshape(-1, 4)
    out = np.empty((n, query_size, query_size, 3), np.uint8)
    status = np.zeros(n, np.uint8)
    flips = np.ascontiguousarray(flips, np.uint8)
    if n:
        loader.ail_prep_queries(
            n, ctypes.cast(table, ctypes.c_void_p), _ptr(hw), _ptr(crops),
            _ptr(flips), int(query_size), _ptr(out), _ptr(status),
            int(n_threads))
    del arrays
    _raise_failed(status, "prep_queries", hw)
    return out


def space_to_depth(arr: np.ndarray, n_threads: int = 8) -> np.ndarray:
    """[N, H, W, 3] uint8 -> [N, H/2, W/2, 12] (transforms.space_to_depth
    on C++ threads)."""
    loader, _ = _libs()
    n, h, w, c = arr.shape
    if arr.dtype != np.uint8 or c != 3 or h % 2 or w % 2:
        raise ValueError(f"space_to_depth takes [N, H, W, 3] uint8 with even "
                         f"sides, got {arr.dtype} {arr.shape}")
    arr = np.ascontiguousarray(arr)
    out = np.empty((n, h // 2, w // 2, 12), np.uint8)
    if n:
        loader.ail_space_to_depth(n, h, w, _ptr(arr), _ptr(out),
                                  int(n_threads))
    return out


def bbox_iou_xywh(dt: np.ndarray, gt: np.ndarray,
                  iscrowd: np.ndarray) -> np.ndarray:
    """Pairwise IoU [D, G] float64 of xywh boxes; a crowd gt's union is the
    detection's area."""
    _, evals = _libs()
    dt = np.ascontiguousarray(dt, np.float64).reshape(-1, 4)
    gt = np.ascontiguousarray(gt, np.float64).reshape(-1, 4)
    iscrowd = np.ascontiguousarray(iscrowd, np.uint8)
    out = np.zeros((len(dt), len(gt)), np.float64)
    if len(dt) and len(gt):
        evals.ait_bbox_iou_xywh(len(dt), _ptr(dt), len(gt), _ptr(gt),
                                _ptr(iscrowd), _ptr(out))
    return out


def greedy_match(ious: np.ndarray, gt_ignore: np.ndarray,
                 iscrowd: np.ndarray, thrs: np.ndarray):
    """Per-threshold greedy matching of score-sorted detections to gts
    sorted ignore-last: (dtm [T, D] int64 matched gt index + 1 or 0,
    dt_ignore [T, D] uint8)."""
    _, evals = _libs()
    ious = np.ascontiguousarray(ious, np.float64)
    gt_ignore = np.ascontiguousarray(gt_ignore, np.uint8)
    iscrowd = np.ascontiguousarray(iscrowd, np.uint8)
    thrs = np.ascontiguousarray(thrs, np.float64)
    t, d, g = len(thrs), ious.shape[0], ious.shape[1]
    dtm = np.zeros((t, d), np.int64)
    dt_ig = np.zeros((t, d), np.uint8)
    if t and d:
        evals.ait_greedy_match(t, _ptr(thrs), d, g, _ptr(ious),
                               _ptr(gt_ignore), _ptr(iscrowd), _ptr(dtm),
                               _ptr(dt_ig))
    return dtm, dt_ig


def nms_xyxy(boxes: np.ndarray, thresh: float) -> np.ndarray:
    """Greedy keep mask [N] bool over score-sorted xyxy boxes (the +1 area
    convention); a host reference, the device path is csrc/nms.cu."""
    _, evals = _libs()
    boxes = np.ascontiguousarray(boxes, np.float64).reshape(-1, 4)
    keep = np.zeros(len(boxes), np.uint8)
    if len(boxes):
        evals.ait_nms_xyxy(len(boxes), _ptr(boxes), float(thresh),
                           _ptr(keep))
    return keep.astype(bool)

