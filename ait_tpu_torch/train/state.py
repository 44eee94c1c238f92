"""Train and eval steps (counterpart of ait_tpu/train/state.py).

    model = AITDetector(cfg)             # Config(): t_dropout 0.1
    model.load_state_dict(state_dict)
    optimizer = make_optimizer(cfg, model)
    step = make_train_step(model, optimizer, lr_schedule(...))   # on the GPU
    metrics = step(batch, torch.Generator("cuda").manual_seed(0))

A step is the forward with the five losses, the backward (the fused
kernels' backward kernels on the transformer, torch autograd elsewhere),
the optimizer's global-norm clip where it has one, and one update (SGD or
Adam, train/optim.py) at the schedule's lr for the step.  The step's generator is
its only source of randomness: in one fixed order it draws the co-attention's
dropout seeds, the anchor and proposal sampling uniforms, then the
transformer's dropout seeds (models/dropout.py), so one generator state gives
one step, on the kernel path or the plain path alike.  With accum_steps = A
> 1 the batch runs as A microbatches of B / A in order, each drawing from the
same generator in turn (the port's counterpart of `fold_in(rng, i)`,
state.py:131-159): the gradients are the mean over the microbatches, the loss
metrics their mean, fg_cnt and bg_cnt their sum.

`make_fused_eval_step` is the shot-fused eval step (state.py:188-211): U
unique images and their A query shots each, the image backbone run once per
image and its features gathered to the U * A pair rows.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ait_tpu_torch.device import resolve_device
from ait_tpu_torch.models.detector import AITDetector
from ait_tpu_torch.train.optim import clip_by_global_norm_, set_lr

LOSS_METRICS = {"loss": "total_loss", "rpn_cls": "rpn_loss_cls",
                "rpn_box": "rpn_loss_box", "rcnn_cls": "rcnn_loss_cls",
                "margin": "margin_loss", "rcnn_box": "rcnn_loss_bbox"}


def grads_and_metrics(model: AITDetector, batch: Dict[str, torch.Tensor],
                      generator: torch.Generator,
                      accum_steps: int = 1) -> Dict[str, torch.Tensor]:
    """Forward + backward of the total loss: the gradients accumulate into
    the parameters' .grad; returns the metrics of state.py:107-119 as
    tensors on the model's device.  batch holds 'image', 'query',
    'im_info', 'gt_boxes' (and optionally 'num_boxes').  With accum_steps
    = A > 1 the batch is A microbatches of B / A rows in order (B must
    divide): the accumulated gradients are scaled to their mean, the losses
    are means and the counts sums, all float32 (state.py:107-159)."""

    def one(b):
        out = model(b["image"], b["query"], b["im_info"], b["gt_boxes"],
                    b.get("num_boxes"), train=True, generator=generator)
        out.total_loss.backward()
        fg = (out.rois_label != 0).sum()
        m = {k: getattr(out, f).detach() for k, f in LOSS_METRICS.items()}
        m.update(fg_cnt=fg, bg_cnt=out.rois_label.numel() - fg)
        return m

    if accum_steps == 1:
        return one(batch)
    rows = batch["image"].shape[0]
    micro = rows // accum_steps
    if micro * accum_steps != rows:
        raise ValueError(f"batch {rows} not divisible by "
                         f"accum_steps={accum_steps}")
    if any(p.grad is not None for p in model.parameters()):
        raise ValueError("gradient accumulation starts from empty gradients "
                         "(optimizer.zero_grad(set_to_none=True))")
    total = None
    for i in range(accum_steps):
        m = one({k: v[i * micro:(i + 1) * micro] for k, v in batch.items()})
        m = {k: v.float() for k, v in m.items()}
        total = m if total is None else {k: total[k] + m[k] for k in m}
    inv = 1.0 / accum_steps
    for p in model.parameters():
        if p.grad is not None:
            p.grad.mul_(inv)
    return {k: v if k in ("fg_cnt", "bg_cnt") else v * inv
            for k, v in total.items()}


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
        clip_norm = getattr(optimizer, "clip_norm", None)
        if clip_norm:
            clip_by_global_norm_((p.grad for p in params), clip_norm)
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


def make_fused_eval_step(model: AITDetector) -> Callable:
    """Shot-fused eval step: batch holds U unique images ('image' [U, H, W,
    3], 'im_info' [U, 3]) and their A query shots each ('query' [U, A, q, q,
    3]).  The image backbone runs at batch U and its features are gathered
    to the U * A pair rows (`pair_image_idx`), so A shots pay the image
    backbone once.  Outputs are pair-major [U * A, ...], shot a of image u at
    row u * A + a: the same per-pair program as `make_eval_step` on the
    expanded batch (the gather is exact)."""

    @torch.inference_mode()
    def eval_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        query = batch["query"]
        u, a = query.shape[0], query.shape[1]
        query = query.reshape((u * a,) + tuple(query.shape[2:]))
        im_info = torch.repeat_interleave(batch["im_info"], a, dim=0)
        idx = torch.repeat_interleave(
            torch.arange(u, device=query.device), a)
        out = model(batch["image"], query, im_info, train=False,
                    pair_image_idx=idx)
        return {"rois": out.rois, "cls_prob": out.cls_prob,
                "bbox_pred": out.bbox_pred, "im_info": im_info}

    return eval_step
