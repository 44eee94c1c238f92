"""Optimizer: SGD or Adam with the reference's per-parameter groups, and
global-norm clipping (counterpart of ait_tpu/train/optim.py).

The reference builds one param group per tensor (trainval_net_voc.py:
289-296): biases at lr x (1 + DOUBLE_BIAS) with weight decay only if
BIAS_DECAY, weights at lr with WEIGHT_DECAY, and the frozen parameters (the
stem conv and every FrozenBN array) left out.  Here that is one
`torch.optim.SGD` with a weight group and a bias group.  torch's SGD adds
the coupled L2 term to the gradient before its momentum buffer and steps by
-lr times the buffer, which is exactly the JAX package's optax chain
add_decayed_weights -> trace -> scale_by_learning_rate (optim.py:89-95).
`optimizer="adam"` is `torch.optim.Adam` with the same groups: its
`weight_decay` adds the coupled L2 term to the gradient before the moments
(not AdamW), which is optax's add_decayed_weights -> scale_by_adam ->
scale_by_learning_rate (optim.py:97-103), with optax's defaults b1 0.9, b2
0.999, eps 1e-8 outside the square root.
The step-decay schedule is a plain function of the step.

`clip_norm` (the reference clips for vgg16 only) is optax's
clip_by_global_norm chained in front of the groups (optim.py:111-114):
`clip_by_global_norm_` scales every gradient by clip_norm / norm when the
norm over all gradients is not below clip_norm, dividing by the norm itself
(no epsilon, unlike torch.nn.utils.clip_grad_norm_).  optax's norm runs over
the whole gradient tree, frozen leaves included; the frozen leaves (the stem
conv and every FrozenBN array) sit behind stop_gradient in the JAX model
(ait_tpu/models/resnet.py:108, layers.py:54), so their gradients are zeros
and the norm over the trainable leaves, which is what the port computes, is
the same number.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch
from torch import nn

from ait_tpu_torch import bridge
from ait_tpu_torch.config import Config

FROZEN_BN_PARAMS = ("mean", "var")
BN_MODULE_NAMES = ("bn1", "bn2", "bn3", "downsample_bn")


def param_label(path) -> str:
    """'frozen' | 'bias' | 'weight' for one JAX param path (tuple of str)."""
    keys = [getattr(k, "key", str(k)) for k in path]
    leaf = keys[-1]
    parent = keys[-2] if len(keys) > 1 else ""
    if leaf in FROZEN_BN_PARAMS or parent in BN_MODULE_NAMES:
        return "frozen"
    # the backbone's stem conv1 (+ bn1) is excluded from the optimizer
    if len(keys) >= 2 and keys[0] == "backbone" and keys[1] == "conv1":
        return "frozen"
    # vgg16: "fix the layers before conv3" (vgg16.py:40-42)
    if len(keys) >= 2 and keys[0] == "backbone" and (
            keys[1].startswith("conv1_") or keys[1].startswith("conv2_")):
        return "frozen"
    # the reference groups any param whose name contains 'bias'
    if leaf == "bias" or leaf.startswith("b_") or "bias" in leaf:
        return "bias"
    return "weight"


def lr_schedule(base_lr: float, steps_per_epoch: int, decay_step_epochs: int,
                gamma: float, warmup_steps: int = 0) -> Callable[[int], float]:
    """Step decay, lr * gamma^floor(step / (decay_step_epochs *
    steps_per_epoch)), after an optional linear warmup from 0 over
    warmup_steps (then the decay restarts its count)."""
    transition = decay_step_epochs * steps_per_epoch

    def decay(step: int) -> float:
        if transition <= 0:
            return base_lr
        return base_lr * gamma ** (step // transition)

    if not warmup_steps:
        return decay

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return base_lr * step / warmup_steps
        return decay(step - warmup_steps)

    return schedule


def make_optimizer(cfg: Config, model: nn.Module, *, optimizer: str = "sgd",
                   clip_norm: Optional[float] = None) -> torch.optim.Optimizer:
    """SGD (or Adam) over `model`'s trainable parameters in two groups; each
    group carries its `lr_mult`, and `set_lr` sets its lr from the base lr.
    Parameters labelled 'frozen' are left out and stop needing gradients.
    clip_norm is kept on the optimizer (`.clip_norm`) for `make_train_step`,
    which clips the global gradient norm before the update."""
    if optimizer not in ("sgd", "adam"):
        raise ValueError(f"optimizer must be 'sgd' or 'adam', got {optimizer!r}")
    t = cfg.TRAIN
    params = dict(model.named_parameters())
    groups = {"weight": [], "bias": []}
    for key, path, _, _ in bridge.mappings(model):
        p = params.get(key)
        if p is None:                       # a buffer (FrozenBN)
            continue
        label = param_label(path)
        if label == "frozen":
            p.requires_grad_(False)
        else:
            groups[label].append(p)
    param_groups = [
        {"params": groups["weight"], "lr_mult": 1.0,
         "weight_decay": t.WEIGHT_DECAY},
        {"params": groups["bias"], "lr_mult": 1.0 + int(t.DOUBLE_BIAS),
         "weight_decay": t.WEIGHT_DECAY if t.BIAS_DECAY else 0.0}]
    if optimizer == "sgd":
        opt = torch.optim.SGD(param_groups, lr=t.LEARNING_RATE,
                              momentum=t.MOMENTUM)
    else:
        opt = torch.optim.Adam(param_groups, lr=t.LEARNING_RATE,
                               betas=(0.9, 0.999), eps=1e-8)
    opt.clip_norm = clip_norm or None
    return opt


def clip_by_global_norm_(grads: Iterable[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: with norm = sqrt(sum of every
    gradient's sum of squares), each gradient stays as it is where norm <
    max_norm and becomes g / norm * max_norm otherwise.  Returns the norm
    (a tensor; nothing here waits for the device)."""
    grads = list(grads)
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))
    return norm


def set_lr(optimizer: torch.optim.Optimizer, base_lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = base_lr * group["lr_mult"]
