"""Caffe-style ResNet backbone with frozen BN (counterpart of
ait_tpu/models/resnet.py).

The bottleneck puts its stride on conv1 (1x1), the stem max pool is
3/2/ceil, every BatchNorm is frozen; backbone = stem + layer1..3 (C=1024,
stride 16), top = layer4 + global spatial mean (2048-d).  The stem conv is
frozen (`requires_grad=False`), as the reference's optimizer excludes it and
the JAX package stops its gradient (resnet.py:106-108).  On a 3-channel
image the stem is the plain 7x7/2 convolution.  On the loader's
space-to-depth image ([B, H/2, W/2, 12], `tpu.host_s2d`) it is the same
convolution regrouped, as the JAX package runs it (resnet.py:110-118): the
7x7 kernel zero-padded to 8x8 and regrouped into 4x4 over 12 planes, stride
1, padding (2, 1); the 4x4 kernel is derived from `conv1` at each forward.

Public functions take and return NHWC tensors; inside, the convolutions run
NCHW-shaped in the channels_last memory format.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ait_tpu_torch.models.layers import (Conv, FrozenBatchNorm, max_pool_ceil,
                                         to_nchw, to_nhwc)

# blocks per stage of each variant (ait_tpu/models/resnet.py:34-38)
STAGES = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3),
          "resnet152": (3, 8, 36, 3)}


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


def s2d_stem_weight(w):
    """The 7x7/2 stem kernel [64, 3, 7, 7] as the 4x4/1 kernel over the 12
    space-to-depth planes [64, 12, 4, 4] (plane dy*6 + dx*3 + c): padded to
    8x8 at the top and left, then tap (2a + dy, 2b + dx) of channel c goes
    to tap (a, b) of plane dy*6 + dx*3 + c."""
    o = w.shape[0]
    w8 = F.pad(w, (1, 0, 1, 0))
    w8 = w8.reshape(o, 3, 4, 2, 4, 2)                    # o, c, a, dy, b, dx
    return w8.permute(0, 3, 5, 1, 2, 4).reshape(o, 12, 4, 4)


class ResNetBackbone(nn.Module):
    """stem + layer1-3 on NHWC tensors."""

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

    def stem(self, x):
        """The stem convolution on NCHW: [B, 3, H, W] or its space-to-depth
        form [B, 12, H/2, W/2] -> [B, 64, H/2, W/2]."""
        if x.shape[1] != 12:
            return self.conv1(x)
        conv = self.conv1
        w4 = s2d_stem_weight(conv.weight).to(conv.dtype)
        return F.conv2d(F.pad(x.to(conv.dtype), (2, 1, 2, 1)), w4)

    def forward(self, x):
        """[B, H, W, 3], or its space-to-depth form [B, H/2, W/2, 12], ->
        [B, H/16, W/16, 1024]."""
        x = torch.relu(self.bn1(self.stem(to_nchw(x))))
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
