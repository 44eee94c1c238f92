"""The one general generator of the benchmark's inputs.

A traffic mix is a JSON file of parameters (portbench/traffic/<mix>.json);
this module turns it and a seed into batches of (target canvas, query crop,
image info[, gt boxes]).  Every seed gets the same multiset of canvas
buckets and content sizes, in another order and with other pixels, so the
work of a batch does not depend on the seed.

Parameters of a mix:
- "batch": pairs a batch; "pool": distinct batches made at set-up and
  cycled through by the window;
- "buckets": [{"canvas": [H, W], "count": n}, ...], one canvas a batch,
  counts summing to "pool";
- "content_short", "content_long": [lo, hi]: the image's sides inside its
  canvas (landscape when W >= H: height short, width long), the long sides
  of a bucket's images evenly spaced over [lo, hi] and shuffled;
- "scale": im_info's scale (the resize from the original image);
- "query": the query crop's side;
- "blocky": the side of the random colour blocks an image is made of;
- "gt_boxes": [lo, hi] boxes an image (training only; every count in
  turn over a batch's images, shuffled) and "gt_side": [lo, hi] their sides
  in pixels;
- "s2d": ship the canvas as the loader does with tpu.host_s2d, [H/2, W/2,
  12] with plane dy*6 + dx*3 + c.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

CANVAS_FILL = (124, 116, 104)   # the mean pixel, which normalizes to ~0


def _image(rng, h, w, block):
    """An RGB uint8 image of random colour blocks with pixel noise on
    them, so that features vary at every scale."""
    bh, bw = -(-h // block), -(-w // block)
    coarse = rng.integers(0, 256, (bh, bw, 3), dtype=np.int16)
    img = np.repeat(np.repeat(coarse, block, 0), block, 1)[:h, :w]
    noise = rng.integers(-24, 25, (h, w, 3), dtype=np.int16)
    return np.clip(img + noise, 0, 255).astype(np.uint8)


def space_to_depth(x):
    """[..., H, W, 3] -> [..., H/2, W/2, 12], plane dy*6 + dx*3 + c."""
    *lead, h, w, c = x.shape
    x = x.reshape(*lead, h // 2, 2, w // 2, 2, c)
    x = np.moveaxis(x, -4, -3)                # ..., H/2, W/2, dy, dx, c
    return np.ascontiguousarray(x.reshape(*lead, h // 2, w // 2, 4 * c))


def make_batches(mix: Dict, seed: int, train: bool = False) -> List[Dict]:
    """The pool of batches of `mix` for `seed`: dicts of numpy arrays
    'image' [B, H, W, 3] (or its s2d form), 'query' [B, q, q, 3] uint8,
    'im_info' [B, 3] float32 (h, w, scale) and, for training, 'gt_boxes'
    [B, G, 5] float32 (x1, y1, x2, y2, class 1; zero rows pad) and
    'num_boxes' [B] int32."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 17]))
    b, pool = int(mix["batch"]), int(mix["pool"])
    if sum(int(k["count"]) for k in mix["buckets"]) != pool:
        raise ValueError(f"bucket counts do not sum to the pool, {pool}")
    lo, hi = mix["content_long"]
    jobs = []                       # (canvas, the content long sides)
    for k in mix["buckets"]:
        n = int(k["count"])
        longs = np.round(np.linspace(lo, hi, b * n)).astype(int)
        longs = longs[rng.permutation(b * n)].reshape(n, b)
        jobs += [(tuple(k["canvas"]), longs[i]) for i in range(n)]
    jobs = [jobs[i] for i in rng.permutation(pool)]
    short, q = int(mix["content_short"]), int(mix["query"])
    out = []
    for (ch, cw), longs in jobs:
        imgs = np.empty((b, ch, cw, 3), np.uint8)
        imgs[:] = np.asarray(CANVAS_FILL, np.uint8)
        info = np.zeros((b, 3), np.float32)
        for j in range(b):
            h, w = (short, longs[j]) if cw >= ch else (longs[j], short)
            h, w = min(h, ch), min(w, cw)
            imgs[j, :h, :w] = _image(rng, h, w, int(mix["blocky"]))
            info[j] = (h, w, float(mix["scale"]))
        batch = {"image": space_to_depth(imgs) if mix.get("s2d") else imgs,
                 "query": np.stack([_image(rng, q, q, int(mix["blocky"]))
                                    for _ in range(b)]),
                 "im_info": info}
        if train:
            batch.update(_gt_boxes(rng, mix, info))
        out.append(batch)
    return out


def _gt_boxes(rng, mix, info):
    b = info.shape[0]
    g_max = int(mix["max_gt_boxes"])
    glo, ghi = mix["gt_boxes"]
    slo, shi = mix["gt_side"]
    gt = np.zeros((b, g_max, 5), np.float32)
    num = np.resize(np.arange(glo, ghi + 1, dtype=np.int32), b)
    num = num[rng.permutation(b)]
    for j in range(b):
        h, w = info[j, 0], info[j, 1]
        n = int(num[j])
        for k in range(n):
            bw = float(rng.uniform(slo, min(shi, w - 1)))
            bh = float(rng.uniform(slo, min(shi, h - 1)))
            x1 = float(rng.uniform(0, w - 1 - bw))
            y1 = float(rng.uniform(0, h - 1 - bh))
            gt[j, k] = (x1, y1, x1 + bw, y1 + bh, 1.0)
    return {"gt_boxes": gt, "num_boxes": num}
