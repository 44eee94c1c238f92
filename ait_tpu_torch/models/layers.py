"""Shared building blocks (counterpart of ait_tpu/models/layers.py).

Parameters keep the JAX package's names, so the weight bridge maps each
leaf by path: `Conv` and `Dense` hold PyTorch layouts (weight [O, I, kh, kw]
and [O, I]), `Params` holds raw leaves in the JAX layout (the attention
blocks compute x @ w), `FrozenBatchNorm` holds its four constant arrays.
Like flax's `dtype=`, `Conv` and `Dense` cast their input and parameters to
the compute dtype at use; the parameters themselves stay float32.  Every
parameter is trainable (`requires_grad`) unless its module freezes it, as the
ResNet stem does; the FrozenBN arrays are buffers.

Convolutions run on NCHW-shaped tensors in the channels_last memory format:
a JAX NHWC array permuted to NCHW is exactly that, without a copy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class Params(nn.Module):
    """Raw parameter leaves in the JAX layout: Params(kernel=(512, 512))."""

    def __init__(self, **shapes: Tuple[int, ...]):
        super().__init__()
        for name, shape in shapes.items():
            self.register_parameter(
                name, nn.Parameter(torch.zeros(shape)))


class Conv(nn.Module):
    """flax nn.Conv with an explicit symmetric padding, on NCHW tensors."""

    def __init__(self, cin: int, cout: int, k: int, *, stride: int = 1,
                 padding: int = 0, groups: int = 1, bias: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride, self.padding, self.groups = stride, padding, groups
        self.dtype = dtype

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), b,
                        self.stride, self.padding, 1, self.groups)


class Dense(nn.Module):
    """flax nn.Dense over the last axis."""

    def __init__(self, cin: int, cout: int, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dtype = dtype

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


# The eval-time program of models.resnet.fold_frozen_bn (counterpart of
# ait_tpu/models/layers.py:21): with each BN's scale folded into its conv's
# kernel, every FrozenBatchNorm's w is 1, so with this set it adds only its
# bias.  Off by default, as in JAX; never set it with unfolded weights (the
# scale would be ignored).
BN_BIAS_ONLY = False


class FrozenBatchNorm(nn.Module):
    """BatchNorm frozen for the whole run: a constant per-channel affine on
    NCHW tensors, x * w + b with w = scale * rsqrt(var + eps) and
    b = bias - mean * w computed in f32, then cast to x's dtype (x + b
    under BN_BIAS_ONLY)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        for name, init in (("scale", 1.0), ("bias", 0.0), ("mean", 0.0),
                           ("var", 1.0)):
            self.register_buffer(name, torch.full((features,), init))
        self.eps = eps

    def forward(self, x):
        w = self.scale * torch.rsqrt(self.var + self.eps)
        b = self.bias - self.mean * w
        if BN_BIAS_ONLY:
            return x + b.to(x.dtype)[None, :, None, None]
        return (x * w.to(x.dtype)[None, :, None, None] +
                b.to(x.dtype)[None, :, None, None])


class ZeroInitGroupNorm(nn.Module):
    """flax's GroupNorm as the non-local co-attention uses it
    (ait_tpu/models/layers.py:101-119): 32 groups over the channels of an
    NHWC tensor, eps 1e-5, statistics in f32 (var = E[x^2] - E[x]^2,
    clipped at 0), the affine (scale, bias, zero-initialised so the residual
    branch starts as the identity) in f32.  Like flax, the output is f32
    whatever x's dtype.  The params sit under `GroupNorm_0`, flax's path."""

    groups, eps = 32, 1e-5

    def __init__(self, features: int):
        super().__init__()
        self.GroupNorm_0 = Params(scale=(features,), bias=(features,))

    def forward(self, x):
        *lead, c = x.shape
        g = x.float().reshape(lead[0], -1, self.groups, c // self.groups)
        mean = g.mean(dim=(1, 3), keepdim=True)
        var = ((g * g).mean(dim=(1, 3), keepdim=True) -
               mean * mean).clamp_min(0.0)
        p = self.GroupNorm_0
        mul = torch.rsqrt(var + self.eps) * p.scale.reshape(
            self.groups, c // self.groups)
        y = (g - mean) * mul + p.bias.reshape(self.groups, c // self.groups)
        return y.reshape(*lead, c)


def max_pool_ceil(x, window: int, stride: int):
    """Max pool with padding 0 and ceil_mode (the reference backbone's
    MaxPool2d(3, 2, padding=0, ceil_mode=True)) on NCHW tensors."""
    return F.max_pool2d(x, window, stride, 0, ceil_mode=True)


def sinusoid_table(n_position: int, d_hid: int) -> np.ndarray:
    """Sinusoidal positions [n_position, d_hid] float32 (Models.py:34-45)."""
    pos = np.arange(n_position)[:, None]
    dim = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000.0, 2 * (dim // 2) / d_hid)
    table = np.zeros((n_position, d_hid), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


def to_nchw(x):
    """NHWC -> NCHW view in the channels_last memory format."""
    return x.permute(0, 3, 1, 2)


def to_nhwc(x):
    """NCHW -> NHWC, contiguous (a view when x is channels_last)."""
    return x.permute(0, 2, 3, 1).contiguous()

