"""Detection overlays (counterpart of ait_tpu/utils/visualize.py), without
cv2, imageio or PIL.

`draw_detections` draws as the JAX package's does with cv2, pixel for
pixel: each detection above the threshold gets `cv2.rectangle(im, p1, p2,
(0, 204, 0), 2)` and the label `cv2.putText(im, f"{label}: {score:.3f}",
(x1, max(y1 - 2, 10)), FONT_HERSHEY_PLAIN, 1.0, (0, 0, 255), 1)`:

* the rectangle of thickness 2 is, for corners (x1, y1), (x2, y2), a band
  three pixels wide centred on each side (rows y - 1 .. y + 1 over the
  columns between the corners, likewise for the columns) and a plus of
  radius 1 at each corner, all in one colour;
* the label is a row of glyphs from `_font_plain.GLYPHS` (tabulated from
  cv2 by tools/port_font_table.py), each an 8-bit coverage mask at a fixed
  offset from the pen, blended in glyph after glyph as
  (old * (255 - a) + colour * a + 127) // 255, the pen moving by whole
  pixels.

Both clip at the image's edges.  `compose_with_query` puts the query,
resized to the image's height with `data/transforms.py::resize_linear` (bit
for bit `cv2.resize`), beside the image.  `write_png` writes an 8-bit PNG
with the standard library's zlib, RGB as given (the JAX package flips to
BGR because cv2.imwrite takes BGR; the file is the same); `read_png` reads
such a file back.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ait_tpu_torch.data.transforms import (TORCHVISION_MEAN, TORCHVISION_STD,
                                           resize_linear)
from ait_tpu_torch.utils._font_plain import GLYPHS

BOX_COLOR = (0, 204, 0)
TEXT_COLOR = (0, 0, 255)


def _fill(im: np.ndarray, y0: int, y1: int, x0: int, x1: int,
          color) -> None:
    """im[y0:y1 + 1, x0:x1 + 1] = color, clipped to the image."""
    h, w = im.shape[:2]
    y0, y1 = max(y0, 0), min(y1, h - 1)
    x0, x1 = max(x0, 0), min(x1, w - 1)
    if y0 <= y1 and x0 <= x1:
        im[y0:y1 + 1, x0:x1 + 1] = color


def rectangle(im: np.ndarray, p1, p2, color) -> None:
    """cv2.rectangle(im, p1, p2, color, 2) in place."""
    (x1, y1), (x2, y2) = p1, p2
    xa, xb = min(x1, x2), max(x1, x2)
    ya, yb = min(y1, y2), max(y1, y2)
    for y in (y1, y2):                       # the horizontal sides
        _fill(im, y - 1, y + 1, xa, xb, color)
    for x in (x1, x2):                       # the vertical sides
        _fill(im, ya, yb, x - 1, x + 1, color)
    for x, y in ((x1, y1), (x2, y1), (x2, y2), (x1, y2)):   # the caps
        _fill(im, y - 1, y + 1, x, x, color)
        _fill(im, y, y, x - 1, x + 1, color)


def put_text(im: np.ndarray, text: str, org, color) -> None:
    """cv2.putText(im, text, org, FONT_HERSHEY_PLAIN, 1.0, color, 1) in
    place, for printable ASCII."""
    h, w = im.shape[:2]
    x, y = org
    col = np.asarray(color, np.int32)[: im.shape[2]]
    for ch in text:
        if ch not in GLYPHS:
            raise ValueError(f"no glyph for {ch!r}: the label font covers "
                             "printable ASCII")
        adv, dx, dy, gw, gh, cover = GLYPHS[ch]
        x0, y0 = x + dx, y + dy
        cx0, cy0 = max(x0, 0), max(y0, 0)
        cx1, cy1 = min(x0 + gw, w), min(y0 + gh, h)
        if cx0 < cx1 and cy0 < cy1:
            a = np.frombuffer(bytes.fromhex(cover), np.uint8).reshape(gh, gw)
            a = a[cy0 - y0:cy1 - y0, cx0 - x0:cx1 - x0, None].astype(np.int32)
            old = im[cy0:cy1, cx0:cx1].astype(np.int32)
            im[cy0:cy1, cx0:cx1] = (old * (255 - a) + col * a + 127) // 255
        x += adv


def draw_detections(image: np.ndarray, dets: np.ndarray,
                    thresh: float = 0.8, label: str = "shot") -> np.ndarray:
    """image: [H, W, 3] uint8 (RGB); dets: [N, 5] x1,y1,x2,y2,score.  A
    copy with the detections whose score is above `thresh` drawn."""
    im = np.ascontiguousarray(image.copy())
    for d in np.asarray(dets).reshape(-1, 5):
        if d[4] <= thresh:
            continue
        p1 = (int(d[0]), int(d[1]))
        p2 = (int(d[2]), int(d[3]))
        rectangle(im, p1, p2, BOX_COLOR)
        put_text(im, f"{label}: {d[4]:.3f}", (p1[0], max(p1[1] - 2, 10)),
                 TEXT_COLOR)
    return im


def denormalize_query(query: np.ndarray) -> np.ndarray:
    """[128, 128, 3] normalized floats (or raw uint8) -> uint8 RGB."""
    if query.dtype == np.uint8:
        return query
    q = query * TORCHVISION_STD + TORCHVISION_MEAN
    return np.clip(q * 255.0, 0, 255).astype(np.uint8)


def compose_with_query(image: np.ndarray, query: np.ndarray) -> np.ndarray:
    """Side by side: the target image and the query patch resized to the
    image's height (bilinear, as cv2.resize)."""
    h = image.shape[0]
    q = resize_linear(denormalize_query(query), (h, h))
    return np.concatenate([image, q], axis=1)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data +
            struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> None:
    """An [H, W, 3] (RGB) or [H, W] uint8 array as an 8-bit PNG."""
    im = np.ascontiguousarray(image)
    if im.dtype != np.uint8 or im.ndim not in (2, 3) or \
            (im.ndim == 3 and im.shape[2] != 3):
        raise ValueError(f"write_png takes [H, W, 3] or [H, W] uint8, got "
                         f"{im.dtype} {im.shape}")
    h, w = im.shape[:2]
    color_type = 2 if im.ndim == 3 else 0
    rows = im.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                            0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """A PNG as `write_png` writes it (8-bit RGB or gray, rows unfiltered)
    -> [H, W, 3] / [H, W] uint8; any other PNG raises."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos:pos + 4])
        kind, data = blob[pos + 4:pos + 8], blob[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    w, h, depth, color_type, _, _, interlace = header
    channels = {0: 1, 2: 3}.get(color_type)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"{path}: read_png takes 8-bit non-interlaced gray "
                         f"or RGB, got depth {depth} colour type "
                         f"{color_type} interlace {interlace}")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(h, 1 + w * channels)
    if rows[:, 0].any():
        raise ValueError(f"{path}: read_png takes unfiltered rows, got "
                         f"filter types {sorted(set(rows[:, 0].tolist()))}")
    out = rows[:, 1:].copy()
    return out.reshape(h, w, channels) if channels > 1 else out
