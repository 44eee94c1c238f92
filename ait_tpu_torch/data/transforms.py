"""Host-side image preparation (counterpart of ait_tpu/data/transforms.py),
numpy only.

* `prep_image`: shortest-side scale to `target_size` (optionally capped to
  fit a canvas), bilinear; float images are normalized first, uint8 images
  stay uint8 and the device normalizes them.
* `crop_query`: cut the query box, center-pad it square, resize it to
  query_size x query_size.
* `place_on_canvas`: top-left on a fixed canvas padded with the mean pixel.
* `space_to_depth`: [H, W, 3] -> [H/2, W/2, 12], the layout of the ResNet
  stem's 12-plane convolution.

The JAX package resizes with `cv2.resize(..., INTER_LINEAR)`; the GPU
machine has no cv2, so `resize_linear` is a numpy copy of that resize:
half-pixel centres, edges clamped, float32 coefficients; for uint8 the
11-bit fixed-point weights and the rounding of OpenCV's vectorised row
pass; an exact 2x downscale as OpenCV runs it (a 2x2 box mean); a resize to
the same size as a copy.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

TORCHVISION_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
TORCHVISION_STD = np.array([0.229, 0.224, 0.225], np.float32)
# the padding of a uint8 canvas: the mean pixel, round(mean * 255) = (124,
# 116, 104), which the device's normalize maps to ~0, as the reference pads
# its batches with zeros in normalized space; zero would normalize to
# (-2.12, -2.04, -1.80)
CANVAS_FILL = tuple(int(v) for v in np.round(TORCHVISION_MEAN * 255.0))

_COEF_BITS = 11                      # OpenCV's INTER_RESIZE_COEF_BITS
_COEF_SCALE = 1 << _COEF_BITS


def to_rgb3(im: np.ndarray) -> np.ndarray:
    if im.ndim == 2:
        im = np.repeat(im[:, :, None], 3, axis=2)
    if im.shape[2] == 4:  # RGBA
        im = im[:, :, :3]
    return im


def normalize(im: np.ndarray) -> np.ndarray:
    im = im.astype(np.float32) / 255.0
    return (im - TORCHVISION_MEAN) / TORCHVISION_STD


def _taps(dst_n: int, src_n: int, scale: float, clamp_weight: bool,
          exact: bool):
    """Source index and fraction of each output index along one axis:
    (d + 0.5) * scale - 0.5 split at its floor, the position rounded to
    float32 before the split (uint8 images) or the fraction after it (float
    images, `exact`).  The column pass (clamp_weight) moves a tap past
    either edge onto the edge pixel with weight 1; the row pass keeps the
    weights and clamps only the rows it reads."""
    f = (np.arange(dst_n, dtype=np.float64) + 0.5) * scale - 0.5
    if not exact:
        f = f.astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s).astype(np.float32)
    if clamp_weight:
        low, high = s < 0, s >= src_n - 1
        f[low | high] = 0.0
        s = np.clip(s, 0, src_n - 1)
    s0 = np.clip(s, 0, src_n - 1)
    s1 = np.clip(s + 1, 0, src_n - 1)
    w = np.stack([np.float32(1.0) - f, f], axis=-1)
    return s0, s1, w


def _fixed(w: np.ndarray) -> np.ndarray:
    """Float weights -> OpenCV's 11-bit fixed point (round half to even)."""
    return np.rint(w * np.float32(_COEF_SCALE)).astype(np.int32)


def _box2(im: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Exact 2x downscale: the mean of each 2x2 block (OpenCV's area mode);
    a block cut by an odd edge averages the pixels it has."""
    h, w = im.shape[:2]
    acc = np.zeros((out_h, out_w) + im.shape[2:], np.float64)
    cnt = np.zeros((out_h, out_w, 1), np.float64)
    for dy in (0, 1):
        for dx in (0, 1):
            part = im[dy::2, dx::2].astype(np.float64)
            ph, pw = min(part.shape[0], out_h), min(part.shape[1], out_w)
            acc[:ph, :pw] += part[:ph, :pw]
            cnt[:ph, :pw] += 1
    if im.dtype == np.uint8:
        full = cnt[..., 0] == 4
        out = np.rint(acc / cnt)                 # cut blocks: sum / count
        out[full] = np.floor((acc[full] + 2) / 4)  # (sum + 2) >> 2
        return out.astype(np.uint8)
    return (acc / cnt).astype(im.dtype)


def resize_linear(im: np.ndarray, dsize: Optional[Tuple[int, int]] = None,
                  fx: float = 0.0, fy: float = 0.0) -> np.ndarray:
    """Bilinear resize of an [H, W, C] uint8 or float32 image, as
    `cv2.resize(im, dsize, fx=fx, fy=fy, interpolation=cv2.INTER_LINEAR)`.

    dsize = (width, height); without it the size is round(w * fx) x
    round(h * fy) and the inverse scale 1 / fx, 1 / fy; with it the scale
    is dsize / size."""
    h, w = im.shape[:2]
    if dsize is None:
        inv_x, inv_y = float(fx), float(fy)
        out_w, out_h = int(round(w * inv_x)), int(round(h * inv_y))
    else:
        out_w, out_h = int(dsize[0]), int(dsize[1])
        inv_x, inv_y = out_w / w, out_h / h
    if out_w <= 0 or out_h <= 0:
        raise ValueError(f"resize of {h}x{w} to {out_h}x{out_w}")
    if (out_h, out_w) == (h, w):
        return im.copy()
    scale_x, scale_y = 1.0 / inv_x, 1.0 / inv_y
    if scale_x == 2.0 and scale_y == 2.0:
        return _box2(im, out_h, out_w)

    u8 = im.dtype == np.uint8
    cx0, cx1, wx = _taps(out_w, w, scale_x, True, not u8)
    ry0, ry1, wy = _taps(out_h, h, scale_y, False, not u8)
    if u8:
        ax, ay = _fixed(wx), _fixed(wy)
        # column pass on every source row: S[sx] * a0 + S[sx + 1] * a1
        hor = np.take(im, cx0, axis=1).astype(np.int32)
        hor *= ax[None, :, None, 0]
        right = np.take(im, cx1, axis=1).astype(np.int32)
        right *= ax[None, :, None, 1]
        hor += right
        # row pass as OpenCV's vector code rounds it: each product of
        # (row >> 4) and its weight shifted down 16 bits, then (t + 2) >> 2
        hor >>= 4
        out = np.take(hor, ry0, axis=0)
        out *= ay[:, None, None, 0]
        out >>= 16
        low = np.take(hor, ry1, axis=0)
        low *= ay[:, None, None, 1]
        low >>= 16
        out += low
        out += 2
        out >>= 2
        return out.clip(0, 255).astype(np.uint8)
    hor = np.take(im, cx0, axis=1).astype(np.float32)
    hor *= wx[None, :, None, 0]
    hor += np.take(im, cx1, axis=1) * wx[None, :, None, 1]
    out = np.take(hor, ry0, axis=0)
    out *= wy[:, None, None, 0]
    out += np.take(hor, ry1, axis=0) * wy[:, None, None, 1]
    return out


def prep_image(im: np.ndarray, target_size: int,
               max_hw: Optional[Tuple[int, int]] = None,
               keep_uint8: bool = False) -> Tuple[np.ndarray, float]:
    """Shortest-side scale (optionally capped to fit max_hw) + normalize.

    keep_uint8 resizes the raw uint8 image and skips normalization: the
    device does `(x/255 - mean)/std`."""
    im = to_rgb3(im)
    if not keep_uint8:
        im = normalize(im)
    h, w = im.shape[:2]
    scale = float(target_size) / min(h, w)
    if max_hw is not None:
        scale = min(scale, max_hw[0] / h, max_hw[1] / w)
    return resize_linear(im, fx=scale, fy=scale), scale


def crop_query(image: np.ndarray, box, query_size: int) -> np.ndarray:
    """Cut `box` (x1,y1,x2,y2), center-pad square, resize."""
    image = to_rgb3(image)
    cut = image[int(box[1]):int(box[3]), int(box[0]):int(box[2]), :]
    h, w = cut.shape[:2]
    if h == 0 or w == 0:
        cut = np.zeros((1, 1, 3), image.dtype)
        h = w = 1
    m = max(h, w)
    cty, ctx = h // 2, w // 2
    sq = np.zeros((m, m, 3), cut.dtype)
    x0, x1 = max(0, ctx - m // 2), min(ctx + m // 2, w)
    y0, y1 = max(0, cty - m // 2), min(cty + m // 2, h)
    ys = slice(m // 2 - (cty - y0), m // 2 + (y1 - cty))
    xs = slice(m // 2 - (ctx - x0), m // 2 + (x1 - ctx))
    sq[ys, xs, :] = cut[y0:y1, x0:x1, :]
    return resize_linear(sq, (query_size, query_size))


def place_on_canvas(im: np.ndarray, canvas_hw: Tuple[int, int]) -> np.ndarray:
    """Top-left placement on a canvas that normalizes to ~zero: a uint8
    canvas is padded with the mean pixel, a float one with zeros."""
    if im.dtype == np.uint8:
        out = np.empty((canvas_hw[0], canvas_hw[1], 3), np.uint8)
        out[:] = CANVAS_FILL
    else:
        out = np.zeros((canvas_hw[0], canvas_hw[1], 3), np.float32)
    h = min(im.shape[0], canvas_hw[0])
    w = min(im.shape[1], canvas_hw[1])
    out[:h, :w, :] = im[:h, :w, :]
    return out


def space_to_depth(arr: np.ndarray) -> np.ndarray:
    """[..., H, W, 3] -> [..., H/2, W/2, 12] (channel = dy*6 + dx*3 + c)."""
    *lead, h, w, c = arr.shape
    if h % 2 or w % 2:
        raise ValueError(f"space_to_depth needs even sides, got {h}x{w}")
    out = arr.reshape(*lead, h // 2, 2, w // 2, 2, c)
    nd = out.ndim
    perm = tuple(range(nd - 5)) + (nd - 5, nd - 3, nd - 4, nd - 2, nd - 1)
    return np.ascontiguousarray(out.transpose(perm)).reshape(
        *lead, h // 2, w // 2, 4 * c)
