"""VGG16 backbone and top (counterpart of ait_tpu/models/vgg.py), for
`--net vgg16` (cfgs/vgg16.yml: model.channels 512).

* `VGGBackbone`: conv1_1 .. conv5_3 (3x3, padding 1, ReLU), a 2x2/2 max
  pool (floor) after each block but the last: [B, H, W, 3] ->
  [B, H/16, W/16, 512].  The first two blocks are frozen
  (`requires_grad=False`; vgg16.py:40-42 "fix the layers before conv3"),
  as the JAX package stops their gradients and masks them out of the
  optimizer.
* `VGGTop`: the flattened roi features in NHWC order through fc6 and fc7
  (4096, ReLU), each followed by a dropout at 0.5, the torchvision
  classifier's own rate, whatever model.t_dropout is (vgg16.py:35).  In
  training each of its two dropouts draws a [N, 4096] keep-mask, flax's
  form (x / 0.5 where kept): from the forward's `Dropout` (models/
  dropout.py), injected masks in the CPU parity tests, else the mask dump
  kernel csrc/dropout.cu from a seed (ops/dropout_masks.py `top_keep_mask`).

Public functions take and return NHWC tensors.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ait_tpu_torch.models.dropout import Dropout, flax_dropout
from ait_tpu_torch.models.layers import Conv, Dense, to_nchw, to_nhwc
from ait_tpu_torch.ops import dropout_masks

# channels per conv block; a 2x2 max pool after each block but the last
_BLOCKS = ((64, 64), (128, 128), (256, 256, 256),
           (512, 512, 512), (512, 512, 512))
FROZEN_BLOCKS = 2       # conv1_*, conv2_*: "fix the layers before conv3"
TOP_RATE = 0.5          # VGGTop's two dropouts (nn.Dropout(0.5), vgg.py:87)


class VGGBackbone(nn.Module):
    """[B, H, W, 3] -> [B, H/16, W/16, 512] (conv5_3, no final pool)."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        cin = 3
        for bi, widths in enumerate(_BLOCKS):
            for ci, w in enumerate(widths):
                conv = Conv(cin, w, 3, padding=1, dtype=dtype)
                if bi < FROZEN_BLOCKS:
                    for p in conv.parameters():
                        p.requires_grad_(False)
                self.add_module(f"conv{bi + 1}_{ci + 1}", conv)
                cin = w

    def forward(self, x):
        x = to_nchw(x)
        for bi, widths in enumerate(_BLOCKS):
            for ci in range(len(widths)):
                x = torch.relu(getattr(self, f"conv{bi + 1}_{ci + 1}")(x))
            if bi < len(_BLOCKS) - 1:
                x = F.max_pool2d(x, 2, 2)
        return to_nhwc(x)


class VGGTop(nn.Module):
    """[N, h, w, 512] -> [N, 4096]: fc6 / ReLU / dropout / fc7 / ReLU /
    dropout."""

    def __init__(self, in_features: int = 7 * 7 * 512, dtype=torch.float32):
        super().__init__()
        self.fc6 = Dense(in_features, 4096, dtype=dtype)
        self.fc7 = Dense(4096, 4096, dtype=dtype)

    def _drop(self, x, drop: Optional[Dropout]):
        if drop is None:                       # eval
            return x
        masks = drop.take(tuple(x.shape), device=x.device)
        if masks is not None:
            keep = masks[0]
        else:
            keep = dropout_masks.top_keep_mask(
                drop.seed(x.device), x.shape[0], x.shape[1],
                keep_prob=1.0 - TOP_RATE)
        return flax_dropout(x, keep, 1.0 - TOP_RATE)

    def forward(self, x, drop: Optional[Dropout] = None):
        """drop: the training forward's dropout (None at eval); the rate is
        TOP_RATE, not drop.rate."""
        x = x.reshape(x.shape[0], -1)
        x = self._drop(torch.relu(self.fc6(x)), drop)
        return self._drop(torch.relu(self.fc7(x)), drop)
