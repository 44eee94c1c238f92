"""Caffe-style ResNet backbone with frozen BN (counterpart of
ait_tpu/models/resnet.py).

The bottleneck puts its stride on conv1 (1x1), the stem max pool is
3/2/ceil, every BatchNorm is frozen; backbone = stem + layer1..3 (C=1024,
stride 16), top = layer4 + global spatial mean (2048-d).  The stem conv is
frozen (`requires_grad=False`), as the reference's optimizer excludes it and
the JAX package stops its gradient (resnet.py:106-108).  The stem is the
plain 7x7/2 convolution: the JAX package's space-to-depth rewrite of it is a
TPU matrix-unit layout trick with the same result.

Public functions take and return NHWC tensors; inside, the convolutions run
NCHW-shaped in the channels_last memory format.
"""

from __future__ import annotations

import torch
from torch import nn

from ait_tpu_torch.models.layers import (Conv, FrozenBatchNorm, max_pool_ceil,
                                         to_nchw, to_nhwc)

STAGES = {"resnet50": (3, 4, 6, 3)}


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv(cin, planes, 1, stride=stride, bias=False,
                          dtype=dtype)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = Conv(planes, planes, 3, padding=1, bias=False,
                          dtype=dtype)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = Conv(planes, planes * 4, 1, bias=False, dtype=dtype)
        self.bn3 = FrozenBatchNorm(planes * 4)
        if downsample:
            self.downsample_conv = Conv(cin, planes * 4, 1, stride=stride,
                                        bias=False, dtype=dtype)
            self.downsample_bn = FrozenBatchNorm(planes * 4)
        self.downsample = downsample

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x
        if self.downsample:
            residual = self.downsample_bn(self.downsample_conv(x))
        return torch.relu(y + residual)


class ResNetStage(nn.Module):
    """blocks named block0..blockN-1, as in the JAX tree."""

    def __init__(self, cin: int, planes: int, blocks: int, stride: int = 1,
                 dtype=torch.float32):
        super().__init__()
        needs_ds = stride != 1 or cin != planes * 4
        self.add_module("block0", Bottleneck(cin, planes, stride, needs_ds,
                                             dtype))
        for i in range(1, blocks):
            self.add_module(f"block{i}", Bottleneck(planes * 4, planes,
                                                    dtype=dtype))

    def forward(self, x):
        for block in self.children():
            x = block(x)
        return x


class ResNetBackbone(nn.Module):
    """stem + layer1-3: [B, H, W, 3] -> [B, H/16, W/16, 1024] (NHWC)."""

    def __init__(self, variant: str = "resnet50", dtype=torch.float32):
        super().__init__()
        n1, n2, n3, _ = STAGES[variant]
        self.conv1 = Conv(3, 64, 7, stride=2, padding=3, bias=False,
                          dtype=dtype)
        self.conv1.weight.requires_grad_(False)
        self.bn1 = FrozenBatchNorm(64)
        self.layer1 = ResNetStage(64, 64, n1, 1, dtype)
        self.layer2 = ResNetStage(256, 128, n2, 2, dtype)
        self.layer3 = ResNetStage(512, 256, n3, 2, dtype)

    def forward(self, x):
        x = to_nchw(x)
        x = torch.relu(self.bn1(self.conv1(x)))
        x = max_pool_ceil(x, 3, 2)
        x = self.layer3(self.layer2(self.layer1(x)))
        return to_nhwc(x)


class ResNetTop(nn.Module):
    """layer4 + global spatial mean: [N, h, w, 1024] -> [N, 2048]."""

    def __init__(self, variant: str = "resnet50", dtype=torch.float32):
        super().__init__()
        self.layer4 = ResNetStage(1024, 512, STAGES[variant][3], 2, dtype)

    def forward(self, x):
        return self.layer4(to_nchw(x)).mean(dim=(2, 3))
