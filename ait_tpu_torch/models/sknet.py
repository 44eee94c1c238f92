"""Selective-kernel block of the flagship (counterpart of
ait_tpu/models/sknet.py), 'faithful' gate only.

SKBlock runs two grouped convs (k=1 and k=3, groups=8, ReLU) and, as the
reference does (blocks_coatt_transformer_sk.py:981), returns the sum of the
branch-wise squares f * f: the computed channel gate is dead there, so it
has no parameters here either.
"""

from __future__ import annotations

import torch
from torch import nn

from ait_tpu_torch.models.layers import Conv, to_nchw, to_nhwc


class SKBlock(nn.Module):
    def __init__(self, channels: int, groups: int = 8, dtype=torch.float32):
        super().__init__()
        self.conv0 = Conv(channels, channels, 1, groups=groups, dtype=dtype)
        self.conv1 = Conv(channels, channels, 3, padding=1, groups=groups,
                          dtype=dtype)

    def forward(self, x):
        """[N, H, W, C] (NHWC) -> [N, H, W, C]."""
        x = to_nchw(x)
        f0 = torch.relu(self.conv0(x))
        f1 = torch.relu(self.conv1(x))
        return to_nhwc(f0 * f0 + f1 * f1)


class SKNet(nn.Module):
    """Independent SKBlocks on the proposal and query streams."""

    def __init__(self, channels: int = 1024, dtype=torch.float32):
        super().__init__()
        self.sk_props = SKBlock(channels, dtype=dtype)
        self.sk_query = SKBlock(channels, dtype=dtype)

    def forward(self, x_props, x_query):
        return self.sk_props(x_props), self.sk_query(x_query)
