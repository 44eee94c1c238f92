"""Optimizer: SGD with the reference's per-parameter groups (counterpart of
ait_tpu/train/optim.py).

The reference builds one param group per tensor (trainval_net_voc.py:
289-296): biases at lr x (1 + DOUBLE_BIAS) with weight decay only if
BIAS_DECAY, weights at lr with WEIGHT_DECAY, and the frozen parameters (the
stem conv and every FrozenBN array) left out.  Here that is one
`torch.optim.SGD` with a weight group and a bias group.  torch's SGD adds
the coupled L2 term to the gradient before its momentum buffer and steps by
-lr times the buffer, which is exactly the JAX package's optax chain
add_decayed_weights -> trace -> scale_by_learning_rate (optim.py:89-95).
The step-decay schedule is a plain function of the step.  Adam and global
norm clipping are not ported yet.
"""

from __future__ import annotations

from typing import Callable

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


def make_optimizer(cfg: Config, model: nn.Module) -> torch.optim.SGD:
    """SGD over `model`'s trainable parameters in two groups; each group
    carries its `lr_mult`, and `set_lr` sets its lr from the base lr.
    Parameters labelled 'frozen' are left out and stop needing gradients."""
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
    return torch.optim.SGD(
        [{"params": groups["weight"], "lr_mult": 1.0,
          "weight_decay": t.WEIGHT_DECAY},
         {"params": groups["bias"], "lr_mult": 1.0 + int(t.DOUBLE_BIAS),
          "weight_decay": t.WEIGHT_DECAY if t.BIAS_DECAY else 0.0}],
        lr=t.LEARNING_RATE, momentum=t.MOMENTUM)


def set_lr(optimizer: torch.optim.Optimizer, base_lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = base_lr * group["lr_mult"]
