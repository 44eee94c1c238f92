"""End-to-end trainability check: overfit a tiny synthetic shapes dataset
(counterpart of tools/overfit_smoke.py).

    python -m ait_tpu_torch.tools.overfit_smoke [--steps 300] [--bs 8]
        [--lr 0.01] [--eval_bs 8] [--coatt mha|nonlocal] [--no_dec_prefix]
        [--device cpu]

Generates images of coloured shapes (class = colour x shape), trains the
real pipeline (OneShotLoader -> device_prefetch -> make_train_step, the
reference's hyperparameters, `Config()` in bf16 from `init_params`) for a
few hundred steps, then evaluates one-shot AP on the same set.  A working
training path drives the loss down sharply and pushes mAP far above chance
(about 0.02).  Runs on the GPU unless `--device` names another.

The images are drawn in numpy exactly as the JAX tool draws them with cv2
(filled squares and discs, pixel for pixel, from the same RandomState
draws) and stay in memory: the loader reads them through `imread=`.  The
JAX tool writes them as JPEG and reads them back, so its pixels carry JPEG's
loss; these do not.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ait_tpu_torch.config import Config
from ait_tpu_torch.data import (DatasetView, ImageRecord, OneShotLoader,
                                QueryExemplar, device_prefetch)
from ait_tpu_torch.device import resolve_device
from ait_tpu_torch.evaluation import evaluate_voc, postprocess_detections
from ait_tpu_torch.models import AITDetector
from ait_tpu_torch.train import (init_params, lr_schedule, make_eval_step,
                                 make_optimizer, make_train_step)
from ait_tpu_torch.utils import printer

COLORS = [(220, 40, 40), (40, 200, 40), (60, 60, 230), (230, 220, 40)]
SHAPES = ["rect", "disc"]
CLASSES = ["__background__"] + [f"{s}{ci}" for ci in range(len(COLORS))
                                for s in SHAPES]
LOG_EVERY = 25
EVAL_KEYS = ("image", "query", "im_info")


def fill_rect(im: np.ndarray, p1, p2, color) -> None:
    """cv2.rectangle(im, p1, p2, color, -1): the corners' closed box,
    clipped to the image."""
    h, w = im.shape[:2]
    x0, y0 = max(min(p1[0], p2[0]), 0), max(min(p1[1], p2[1]), 0)
    x1, y1 = min(max(p1[0], p2[0]), w - 1), min(max(p1[1], p2[1]), h - 1)
    if x0 <= x1 and y0 <= y1:
        im[y0:y1 + 1, x0:x1 + 1] = color


def fill_disc(im: np.ndarray, center, r: int, color) -> None:
    """cv2.circle(im, center, r, color, -1) with LINE_8: the horizontal
    spans of OpenCV's midpoint walk, clipped to the image."""
    h, w = im.shape[:2]
    cx, cy = center
    err, dx, dy, plus, minus = 0, r, 0, 1, 2 * r - 1
    while dx >= dy:
        for y, half in ((cy - dy, dx), (cy + dy, dx), (cy - dx, dy),
                        (cy + dx, dy)):
            x0, x1 = max(cx - half, 0), min(cx + half, w - 1)
            if 0 <= y < h and x0 <= x1:
                im[y, x0:x1 + 1] = color
        dy += 1
        err += plus
        plus += 2
        if err > 0:                     # OpenCV's branch-free mask step
            err -= minus
            dx -= 1
            minus -= 2


def make_dataset(root: str = "shapes", n_images: int = 24, seed: int = 0):
    """(view, images): the JAX tool's records, boxes, classes and query
    pools, and {image path: [400, 400, 3] uint8 RGB} for `imread=`."""
    rng = np.random.RandomState(seed)
    records, cat_data = [], {i: [] for i in range(len(CLASSES))}
    images: Dict[str, np.ndarray] = {}
    for idx in range(n_images):
        h = w = 400
        im = rng.randint(90, 150, (h, w, 3)).astype(np.uint8)
        boxes, cls = [], []
        for _ in range(rng.randint(2, 4)):
            c = rng.randint(1, len(CLASSES))
            color = COLORS[(c - 1) // len(SHAPES)]
            shape = SHAPES[(c - 1) % len(SHAPES)]
            size = rng.randint(70, 140)
            x1 = rng.randint(0, w - size)
            y1 = rng.randint(0, h - size)
            if shape == "rect":
                fill_rect(im, (x1, y1), (x1 + size, y1 + size), color)
            else:
                r = size // 2
                fill_disc(im, (x1 + r, y1 + r), r, color)
            boxes.append([x1, y1, x1 + size - 1, y1 + size - 1])
            cls.append(c)
        path = os.path.join(root, f"im{idx:03d}")
        images[path] = im
        records.append(ImageRecord(idx, path, w, h,
                                   np.asarray(boxes, np.float32),
                                   np.asarray(cls, np.int32),
                                   np.zeros(len(cls), np.int32)))
        for b, c in zip(boxes, cls):
            cat_data[c].append(QueryExemplar(path, np.asarray(b, float)))
    view = DatasetView("shapes", tuple(CLASSES), records, cat_data)
    view.allowed_classes = list(range(1, len(CLASSES)))
    return view, images


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--bs", type=int, default=8)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--eval_bs", type=int, default=8)
    p.add_argument("--coatt", default="mha", choices=["mha", "nonlocal"],
                   help="co-attention flavor (mha=VOC model, "
                        "nonlocal=COCO model)")
    p.add_argument("--no_dec_prefix", action="store_true",
                   help="disable the default-on tpu.dec_prefix_per_image "
                        "(restores reference-exact iid per-proposal "
                        "decoder dropout masks)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' to run on "
                        "the CPU)")
    return p.parse_args(argv)


def run(args, cfg: Optional[Config] = None) -> dict:
    """Train, then evaluate the train set.  Returns {'losses': every step's
    total loss, 'logged': the logged steps' metrics, 'train_s': the
    training loop's seconds, 'mAP', 'ap': per-class AP, 'eval_batches',
    'eval_s'}."""
    dev = resolve_device(args.device)
    cfg = cfg or Config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                coattention=args.coatt))
    if args.no_dec_prefix:
        cfg = cfg.replace(tpu=dataclasses.replace(
            cfg.tpu, dec_prefix_per_image=False))
    view, images = make_dataset()
    view_eval, _ = make_dataset()   # same images, fresh (unaugmented) view
    view_eval.allowed_classes = view.allowed_classes

    loader = OneShotLoader(view, cfg, training=True, seed=0,
                           imread=images.__getitem__)
    printer(f"{len(loader)} training records (with flips)")

    model = init_params(AITDetector(cfg, dtype=torch.bfloat16), cfg, 3)
    step = make_train_step(model, make_optimizer(cfg, model),
                           lr_schedule(args.lr, 100, 1000, 0.1), device=dev)
    generator = torch.Generator(dev).manual_seed(0)

    t0 = time.time()
    losses, logged = [], []
    while len(losses) < args.steps:
        for batch in device_prefetch(
                loader.train_epoch(args.bs, num_workers=8), device=dev):
            metrics = step(batch, generator)
            losses.append(metrics["loss"].detach())
            it = len(losses)
            if it == 1 or it % LOG_EVERY == 0:
                m = {k: float(v) for k, v in metrics.items()}
                logged.append((it, m))
                printer(f"step {it:4d} ",
                        f"loss {m['loss']:.3f} "
                        f"(rpn {m['rpn_cls']:.3f}/{m['rpn_box']:.3f} "
                        f"rcnn {m['rcnn_cls']:.3f} "
                        f"margin {m['margin']:.3f} "
                        f"box {m['rcnn_box']:.3f})")
            if it >= args.steps:
                break
    losses = torch.stack(losses).float().cpu().tolist()
    train_s = time.time() - t0
    printer(f"trained {len(losses)} steps in {train_s:.0f}s; loss "
            f"{losses[0]:.3f} -> {losses[-1]:.3f}")

    t0 = time.time()
    model.eval()
    eval_loader = OneShotLoader(view_eval, cfg, training=False,
                                imread=images.__getitem__)
    eval_step = make_eval_step(model)
    all_boxes = {ci: {} for ci in view_eval.allowed_classes}
    done = set()
    eval_batches = 0
    for batch in eval_loader.test_epoch(args.eval_bs, num_workers=8):
        eval_batches += 1
        b = {k: torch.as_tensor(batch[k]).to(dev) for k in EVAL_KEYS}
        out = eval_step(b)
        dets, valid = postprocess_detections(
            out["rois"], out["cls_prob"], out["bbox_pred"], b["im_info"],
            nms_thresh=cfg.TEST.NMS)
        dets, valid = dets.cpu().numpy(), valid.cpu().numpy()
        for i in range(len(batch["pair_index"])):
            pi = int(batch["pair_index"][i])
            if pi in done:
                continue
            done.add(pi)
            all_boxes[int(batch["category"][i])][
                int(batch["record_index"][i])] = dets[i][valid[i]]
    res = evaluate_voc(all_boxes, view_eval.records,
                       view_eval.allowed_classes, CLASSES[1:])
    printer("per-class AP: ",
            "  ".join(f"{k}={v * 100:.0f}" for k, v in res.items()))
    printer(f"RESULT: loss {losses[0]:.3f} -> {losses[-1]:.3f}, "
            f"train-set mAP = {res['mAP'] * 100:.1f}")
    return {"losses": losses, "logged": logged, "train_s": train_s,
            "mAP": res["mAP"],
            "ap": {k: v for k, v in res.items() if k != "mAP"},
            "eval_batches": eval_batches, "eval_s": time.time() - t0}


def main(argv=None, cfg: Optional[Config] = None, device=None) -> float:
    """Train and evaluate; returns the train-set mAP.  `cfg` replaces
    `Config()` (the tests pass a small one); `device` overrides --device."""
    args = parse_args(argv)
    if device is not None:
        args.device = device
    return run(args, cfg)["mAP"]


if __name__ == "__main__":
    main()
