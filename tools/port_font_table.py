#!/usr/bin/env python
"""Tabulate the label font of `cv2.putText(..., cv2.FONT_HERSHEY_PLAIN, 1.0,
color, 1)` as the PyTorch port draws it (ait_tpu_torch/utils/visualize.py).

The port draws its detection overlays without cv2, from a table of the
glyphs of printable ASCII (32-126).  At this one size and thickness, with
OpenCV 5's text renderer, a label is a row of glyphs at whole-pixel
advances: each glyph an 8-bit coverage mask at a fixed offset from the pen
position, blended into the image glyph after glyph as
    out = (old * (255 - a) + color * a + 127) // 255.
This tool measures each glyph's mask, offset and advance from cv2, checks
the model against cv2 on every pair of glyphs, and writes the table to
ait_tpu_torch/utils/_font_plain.py.  Only this tool imports cv2; the port's
modules read the table (tests/test_torch_visualize.py holds the committed
table to cv2's glyphs).

    python tools/port_font_table.py
"""

from __future__ import annotations

import os
import sys

import cv2
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "ait_tpu_torch", "utils", "_font_plain.py")
FONT = cv2.FONT_HERSHEY_PLAIN
CHARS = [chr(c) for c in range(32, 127)]
ORG = (40, 40)                       # the pen position on the probe canvas
CANVAS = (80, 240)


def coverage(text: str, x: int = ORG[0]) -> np.ndarray:
    """cv2's coverage of `text` at (x, ORG[1]): white on black."""
    im = np.zeros(CANVAS + (3,), np.uint8)
    cv2.putText(im, text, (x, ORG[1]), FONT, 1.0, (255, 255, 255), 1)
    return im[:, :, 0].astype(np.int64)


def blend(old: np.ndarray, a: np.ndarray, color: int = 255) -> np.ndarray:
    return (old * (255 - a) + color * a + 127) // 255


def measure():
    """{char: (advance, dx, dy, mask)}: the mask's top-left corner sits at
    pen + (dx, dy); an empty glyph has a 0 x 0 mask."""
    table = {}
    for ch in CHARS:
        a = coverage(ch)
        ys, xs = np.nonzero(a)
        if len(ys):
            y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
            mask = a[y0:y1, x0:x1].astype(np.uint8)
            dx, dy = int(x0 - ORG[0]), int(y0 - ORG[1])
        else:
            mask, dx, dy = np.zeros((0, 0), np.uint8), 0, 0
        # the advance: where a following 'H' lands
        want = coverage(ch + "H")
        base = coverage(ch)
        hits = [adv for adv in range(0, 40)
                if np.array_equal(want, blend(base, coverage("H",
                                                             ORG[0] + adv)))]
        if len(hits) != 1:
            raise SystemExit(f"glyph {ch!r}: advance not unique: {hits}")
        table[ch] = (hits[0], dx, dy, mask)
    return table


def render(table, text: str) -> np.ndarray:
    out = np.zeros(CANVAS, np.int64)
    x = ORG[0]
    for ch in text:
        adv, dx, dy, mask = table[ch]
        h, w = mask.shape
        y0, x0 = ORG[1] + dy, x + dx
        out[y0:y0 + h, x0:x0 + w] = blend(out[y0:y0 + h, x0:x0 + w],
                                          mask.astype(np.int64))
        x += adv
    return out


def check(table) -> int:
    """Pixel differences of the model against cv2 over every pair."""
    bad = 0
    for a in CHARS:
        for b in CHARS:
            if not np.array_equal(render(table, a + b), coverage(a + b)):
                bad += 1
    return bad


def write(table) -> None:
    lines = ['"""The label glyphs of cv2.putText(FONT_HERSHEY_PLAIN, scale 1.0,',
             "thickness 1) for printable ASCII, generated by",
             "tools/port_font_table.py from OpenCV " + cv2.__version__ + ".",
             "",
             "GLYPHS[ch] = (advance, dx, dy, width, height, coverage): the",
             "coverage mask (row-major hex bytes, 0-255) has its top-left",
             'corner at pen + (dx, dy)."""',
             "",
             "GLYPHS = {"]
    for ch, (adv, dx, dy, mask) in table.items():
        h, w = mask.shape
        lines.append(f"    {ch!r}: ({adv}, {dx}, {dy}, {w}, {h},")
        hexs = mask.tobytes().hex()
        chunks = [hexs[i:i + 64] for i in range(0, len(hexs), 64)] or [""]
        for j, c in enumerate(chunks):
            end = ")," if j == len(chunks) - 1 else ""
            lines.append(f'          "{c}"{end}')
    lines.append("}")
    with open(OUT, "w") as f:
        f.write("\n".join(lines) + "\n")


def main() -> int:
    table = measure()
    bad = check(table)
    print(f"{len(table)} glyphs; {bad} of {len(CHARS) ** 2} pairs differ "
          "from cv2")
    if bad:
        return 1
    write(table)
    print("wrote", OUT)
    return 0


if __name__ == "__main__":
    sys.exit(main())
