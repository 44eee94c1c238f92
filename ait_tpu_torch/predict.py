"""One-shot inference API (counterpart of ait_tpu/predict.py).

    predictor = OneShotPredictor(cfg, state_dict)          # on the GPU
    dets = predictor.predict_prepared(canvas_u8, query_u8, im_info)

`predict_prepared` takes canvases already placed as the data loader ships
them: canvas [B, 608, 800, 3] uint8 RGB (the image resized to the 600
scale, placed top-left, the rest filled with the mean pixel `CANVAS_FILL` =
(124, 116, 104), which normalizes to ~0), query crops [B, 128, 128, 3]
uint8 and im_info [B, 3] = (h, w, scale).  It returns one [N, 5] (x1, y1,
x2, y2, score) float32 array per pair, in original image coordinates.  The
resize from a raw image is the loader's work and is not part of the port
yet.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ait_tpu_torch.config import Config
from ait_tpu_torch.device import resolve_device
from ait_tpu_torch.evaluation import postprocess_detections
from ait_tpu_torch.models import AITDetector
from ait_tpu_torch.models.detector import CANVAS_FILL  # noqa: F401
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
