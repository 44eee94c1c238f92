"""Eval step (counterpart of ait_tpu/train/state.py::make_eval_step).

The train step, its targets, losses and optimizer are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ait_tpu_torch.models.detector import AITDetector


def make_eval_step(model: AITDetector) -> Callable:
    """eval_step(batch) -> {'rois', 'cls_prob', 'bbox_pred'}; batch holds
    'image', 'query' and 'im_info' tensors on the model's device."""

    @torch.inference_mode()
    def eval_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = model(batch["image"], batch["query"], batch["im_info"],
                    train=False)
        return {"rois": out.rois, "cls_prob": out.cls_prob,
                "bbox_pred": out.bbox_pred}

    return eval_step
