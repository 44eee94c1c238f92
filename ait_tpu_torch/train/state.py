"""Train and eval steps (counterpart of ait_tpu/train/state.py).

    model = AITDetector(cfg)             # Config(): t_dropout 0.1
    model.load_state_dict(state_dict)
    optimizer = make_optimizer(cfg, model)
    step = make_train_step(model, optimizer, lr_schedule(...))   # on the GPU
    metrics = step(batch, torch.Generator("cuda").manual_seed(0))

A step is the forward with the five losses, the backward (the fused
kernels' backward kernels on the transformer, torch autograd elsewhere) and
one SGD update at the schedule's lr for the step.  The step's generator is
its only source of randomness: in one fixed order it draws the co-attention's
dropout seeds, the anchor and proposal sampling uniforms, then the
transformer's dropout seeds (models/dropout.py), so one generator state gives
one step, on the kernel path or the plain path alike.  Gradient accumulation
(accum_steps > 1) is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ait_tpu_torch.device import resolve_device
from ait_tpu_torch.models.detector import AITDetector
from ait_tpu_torch.train.optim import set_lr


def grads_and_metrics(model: AITDetector, batch: Dict[str, torch.Tensor],
                      generator: torch.Generator,
                      accum_steps: int = 1) -> Dict[str, torch.Tensor]:
    """Forward + backward of the total loss: the gradients accumulate into
    the parameters' .grad; returns the metrics of state.py:107-119 as
    tensors on the model's device.  batch holds 'image', 'query',
    'im_info', 'gt_boxes' (and optionally 'num_boxes')."""
    if accum_steps != 1:
        raise NotImplementedError("gradient accumulation (accum_steps > 1) "
                                  "is not ported yet")
    out = model(batch["image"], batch["query"], batch["im_info"],
                batch["gt_boxes"], batch.get("num_boxes"), train=True,
                generator=generator)
    loss = out.total_loss
    loss.backward()
    fg = (out.rois_label != 0).sum()
    return {"loss": loss.detach(),
            "rpn_cls": out.rpn_loss_cls.detach(),
            "rpn_box": out.rpn_loss_box.detach(),
            "rcnn_cls": out.rcnn_loss_cls.detach(),
            "margin": out.margin_loss.detach(),
            "rcnn_box": out.rcnn_loss_bbox.detach(),
            "fg_cnt": fg, "bg_cnt": out.rois_label.numel() - fg}


def make_train_step(model: AITDetector, optimizer: torch.optim.Optimizer,
                    schedule: Callable[[int], float], *, device=None,
                    accum_steps: int = 1) -> Callable:
    """Returns train_step(batch, generator) -> metrics.  The model moves to
    `device`: the GPU unless the caller names another.  The generator draws
    the dropout seeds and the anchor and proposal sampling of each step; the
    schedule gives the base lr of step 0, 1, ..."""
    dev = resolve_device(device)
    model.to(dev).train()
    params = [p for g in optimizer.param_groups for p in g["params"]]
    step = 0

    def train_step(batch: Dict[str, torch.Tensor],
                   generator: torch.Generator) -> Dict[str, torch.Tensor]:
        nonlocal step
        if not isinstance(generator, torch.Generator):
            raise TypeError("train_step needs a torch.Generator for the "
                            "dropout and the target sampling")
        optimizer.zero_grad(set_to_none=True)
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        metrics = grads_and_metrics(model, batch, generator, accum_steps)
        for p in params:          # weight decay applies to every group member
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        set_lr(optimizer, schedule(step))
        optimizer.step()
        step += 1
        return metrics

    return train_step


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
