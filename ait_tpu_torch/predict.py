"""One-shot inference API (counterpart of ait_tpu/predict.py).

    predictor = OneShotPredictor(cfg, state_dict)          # on the GPU
    predictor = OneShotPredictor.from_run("models/res50/pascal_voc/1.0.0")
    dets = predictor.predict(image_rgb_uint8, query_rgb_uint8, query_box)
    dets = predictor.predict_batch([(image, query_image, query_box), ...])

`from_run` reads a run directory of the port's train CLI (its
`config.json` and the newest checkpoint under `ckpt/`; not an orbax run of
the JAX package); `from_converted_checkpoint` a converted params pickle.

`predict` and `predict_batch` take raw RGB images (uint8, [H, W, 3], or
grey / RGBA) and a query box (x1, y1, x2, y2) in the query image; they
resize the image to the 600 scale on the `tpu.image_size` canvas and crop
the query as the loader does (data/transforms.py), then run
`predict_prepared`.  `predict_prepared` takes canvases already placed:
canvas [B, 608, 800, 3] uint8 RGB (the image resized, placed top-left, the
rest filled with the mean pixel `CANVAS_FILL` = (124, 116, 104), which
normalizes to ~0) or its space-to-depth form [B, 304, 400, 12], query crops
[B, 128, 128, 3] uint8 and im_info [B, 3] = (h, w, scale); or, as
test_net's `--fuse_shots` serves A shots of each image, query crops
[U, A, 128, 128, 3] with the U canvases and im_info rows they belong to.
Each returns one [N, 5] (x1, y1, x2, y2, score) float32 array per pair, in
original image coordinates.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ait_tpu_torch.config import Config
from ait_tpu_torch.data.transforms import (CANVAS_FILL,  # noqa: F401
                                           crop_query, normalize,
                                           place_on_canvas, prep_image,
                                           to_rgb3)
from ait_tpu_torch.device import resolve_device
from ait_tpu_torch.evaluation import postprocess_detections
from ait_tpu_torch.models import AITDetector
from ait_tpu_torch.train import (init_params, make_eval_step,
                                 make_fused_eval_step)
from ait_tpu_torch.train.checkpoint import CheckpointManager
from ait_tpu_torch.utils import annotate, printer


class OneShotPredictor:
    def __init__(self, cfg: Config, state_dict: Dict[str, torch.Tensor],
                 device=None, *, score_thresh: float = 0.0,
                 dtype=torch.bfloat16):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = AITDetector(cfg, dtype=dtype)
        self.model.load_state_dict(state_dict)
        self.model.to(self.device).eval()
        self._eval = make_eval_step(self.model)
        self._fused = make_fused_eval_step(self.model)
        self.score_thresh = score_thresh
        self.batches = 0        # batches served: the id of each one's span

    @classmethod
    def from_run(cls, run_dir: str, device=None,
                 **kw) -> "OneShotPredictor":
        """config.json and the newest checkpoint of a training run.  Without
        a checkpoint the weights stay `init_params`' from seed 0, as the
        JAX package keeps its seeded init (predict.py:57-70), with a
        warning."""
        cfg_path = os.path.join(run_dir, "config.json")
        cfg = Config()
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                cfg = _config_from_json(json.load(f))
        # one process serves: a run trained over a mesh (tpu.tp_size > 1)
        # loads into the one-process model, whose parameters are laid out
        # alike
        cfg = cfg.replace(tpu=dataclasses.replace(cfg.tpu, tp_size=1,
                                                  sp_size=1))
        model = init_params(AITDetector(cfg), cfg, 0)
        ckpt_dir = os.path.join(run_dir, "ckpt")
        restored = None
        if os.path.isdir(ckpt_dir):
            restored = CheckpointManager(ckpt_dir).restore(model)
        if restored is None:
            printer("WARNING: no checkpoint in ", f"{ckpt_dir}: the "
                    "predictor keeps the random weights from seed 0",
                    c="yellow")
        return cls(cfg, model.state_dict(), device, **kw)

    @classmethod
    def from_converted_checkpoint(cls, pkl_path: str,
                                  cfg: Optional[Config] = None, device=None,
                                  **kw) -> "OneShotPredictor":
        """Weights converted from a reference .pth
        (tools/convert_torch_checkpoint.py), overlaid on `init_params`'
        from seed 0 by `convert.load_pretrained`."""
        from ait_tpu_torch.convert import load_pretrained

        cfg = cfg or Config()
        model = init_params(AITDetector(cfg), cfg, 0)
        load_pretrained(model, pkl_path)
        return cls(cfg, model.state_dict(), device, **kw)

    def _tensor(self, x, dtype: Optional[torch.dtype] = None):
        t = torch.as_tensor(x)
        return t.to(self.device, dtype or t.dtype, non_blocking=True)

    @torch.inference_mode()
    def predict_prepared(self, canvas, query, im_info) -> List[np.ndarray]:
        """A 4-D query [B, q, q, 3] pairs row b of canvas and im_info with
        crop b.  A 5-D query [U, A, q, q, 3] holds A shots of each of the U
        images of canvas and im_info: the shot-fused step runs the image
        backbone once an image, and the U * A arrays come back pair-major,
        shot a of image u at u * A + a."""
        with annotate("ait:predict", id=self.batches):
            self.batches += 1
            with annotate("ait:h2d"):
                batch = {"image": self._tensor(canvas),
                         "query": self._tensor(query),
                         "im_info": self._tensor(im_info, torch.float32)}
            with annotate("ait:forward"):
                if batch["query"].dim() == 5:
                    out = self._fused(batch)
                    info = out["im_info"]      # repeated per shot
                else:
                    out = self._eval(batch)
                    info = batch["im_info"]
            t = self.cfg.TEST
            with annotate("ait:postprocess"):
                dets, valid = postprocess_detections(
                    out["rois"], out["cls_prob"], out["bbox_pred"], info,
                    nms_thresh=t.NMS,
                    score_thresh=self.score_thresh,
                    max_per_image=t.MAX_PER_IMAGE,
                    bbox_normalize_means=self.cfg.TRAIN.BBOX_NORMALIZE_MEANS,
                    bbox_normalize_stds=self.cfg.TRAIN.BBOX_NORMALIZE_STDS)
            with annotate("ait:d2h"):
                dets = dets.cpu().numpy()
                valid = valid.cpu().numpy()
            return [dets[i][valid[i]] for i in range(dets.shape[0])]

    def _prep_pair(self, image, query_image, query_box):
        """(canvas, query crop, im_info) of one raw pair, as ait_tpu's
        OneShotPredictor._prep_pair makes them."""
        tpu = self.cfg.tpu
        im, scale = prep_image(to_rgb3(np.asarray(image)),
                               self.cfg.TEST.SCALES[0],
                               max_hw=tpu.image_size,
                               keep_uint8=tpu.input_uint8)
        h, w = im.shape[:2]
        canvas = place_on_canvas(im, tpu.image_size)
        q = crop_query(to_rgb3(np.asarray(query_image)), query_box,
                       self.cfg.TRAIN.query_size)
        if not tpu.input_uint8:
            q = normalize(q)
        return canvas, q, np.array([h, w, scale], np.float32)

    def predict_batch(self, pairs: Sequence[Tuple]) -> List[np.ndarray]:
        """pairs: [(image, query_image, query_box)] -> list of [N, 5] dets."""
        canvases, queries, infos = zip(*[self._prep_pair(*p) for p in pairs])
        return self.predict_prepared(np.stack(canvases), np.stack(queries),
                                     np.stack(infos))

    def predict(self, image, query_image, query_box) -> np.ndarray:
        """One (target image, query image, query box) -> [N, 5] dets."""
        return self.predict_batch([(image, query_image, query_box)])[0]


def _config_from_json(doc: dict) -> Config:
    """Rebuild a Config from save_config's JSON (lists become tuples), as
    ait_tpu/predict.py::_config_from_json does."""

    def rebuild(template, d):
        kw = {}
        for f in dataclasses.fields(template):
            if f.name not in d:
                continue
            cur = getattr(template, f.name)
            v = d[f.name]
            if dataclasses.is_dataclass(cur):
                kw[f.name] = rebuild(cur, v)
            elif isinstance(cur, tuple):
                kw[f.name] = tuple(v)
            else:
                kw[f.name] = v
        return dataclasses.replace(template, **kw)

    return rebuild(Config(), doc)
