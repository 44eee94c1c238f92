"""One-shot inference API (counterpart of ait_tpu/predict.py).

    predictor = OneShotPredictor(cfg, state_dict)          # on the GPU
    dets = predictor.predict(image_rgb_uint8, query_rgb_uint8, query_box)
    dets = predictor.predict_batch([(image, query_image, query_box), ...])

`predict` and `predict_batch` take raw RGB images (uint8, [H, W, 3], or
grey / RGBA) and a query box (x1, y1, x2, y2) in the query image; they
resize the image to the 600 scale on the `tpu.image_size` canvas and crop
the query as the loader does (data/transforms.py), then run
`predict_prepared`.  `predict_prepared` takes canvases already placed:
canvas [B, 608, 800, 3] uint8 RGB (the image resized, placed top-left, the
rest filled with the mean pixel `CANVAS_FILL` = (124, 116, 104), which
normalizes to ~0) or its space-to-depth form [B, 304, 400, 12], query crops
[B, 128, 128, 3] uint8 and im_info [B, 3] = (h, w, scale).  Each returns one
[N, 5] (x1, y1, x2, y2, score) float32 array per pair, in original image
coordinates.
"""

from __future__ import annotations

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
from ait_tpu_torch.train import make_eval_step


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
        self.score_thresh = score_thresh

    def _tensor(self, x, dtype: Optional[torch.dtype] = None):
        t = torch.as_tensor(x)
        return t.to(self.device, dtype or t.dtype, non_blocking=True)

    @torch.inference_mode()
    def predict_prepared(self, canvas, query, im_info) -> List[np.ndarray]:
        batch = {"image": self._tensor(canvas),
                 "query": self._tensor(query),
                 "im_info": self._tensor(im_info, torch.float32)}
        out = self._eval(batch)
        t = self.cfg.TEST
        dets, valid = postprocess_detections(
            out["rois"], out["cls_prob"], out["bbox_pred"], batch["im_info"],
            nms_thresh=t.NMS, score_thresh=self.score_thresh,
            max_per_image=t.MAX_PER_IMAGE,
            bbox_normalize_means=self.cfg.TRAIN.BBOX_NORMALIZE_MEANS,
            bbox_normalize_stds=self.cfg.TRAIN.BBOX_NORMALIZE_STDS)
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
