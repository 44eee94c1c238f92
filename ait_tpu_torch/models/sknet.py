"""Selective-kernel block (counterpart of ait_tpu/models/sknet.py), both
gates.

SKBlock runs two grouped convs (k=1 and k=3, groups=8, ReLU).  With
gate='faithful' (the default) it returns, as the reference does
(blocks_coatt_transformer_sk.py:981), the sum of the branch-wise squares
f * f: the computed channel gate is dead there, so it has no parameters
here either.  With gate='fixed' it applies the gate: u = the branches' sum,
s = its spatial mean, z = fc(s) (C -> C/16), a = sk(z) (C/16 -> 2C), a
softmax over the branch axis in f32 cast back to f's dtype, and the output
is sum over branches of f * a.
"""

from __future__ import annotations

import torch
from torch import nn

from ait_tpu_torch.models.layers import (Conv, Dense, to_nchw, to_nhwc,
                                         variance_scaling)

# the fixed gate's squeeze: fc maps C -> C / REDUCTION
REDUCTION = 16


class SKBlock(nn.Module):
    def __init__(self, channels: int, groups: int = 8,
                 gate: str = "faithful", dtype=torch.float32):
        super().__init__()
        if gate not in ("faithful", "fixed"):
            raise ValueError(f"sk gate must be 'faithful' or 'fixed', got "
                             f"{gate!r}")
        self.gate = gate
        # Kaiming fan_out, truncated (sknet.py:32)
        kaiming = variance_scaling(2.0, "fan_out", "truncated_normal")
        self.conv0 = Conv(channels, channels, 1, groups=groups, dtype=dtype,
                          kernel_init=kaiming)
        self.conv1 = Conv(channels, channels, 3, padding=1, groups=groups,
                          dtype=dtype, kernel_init=kaiming)
        if gate == "fixed":
            self.fc = Dense(channels, channels // REDUCTION, dtype=dtype)
            self.sk = Dense(channels // REDUCTION, 2 * channels, dtype=dtype)

    def forward(self, x):
        """[N, H, W, C] (NHWC) -> [N, H, W, C]."""
        x = to_nchw(x)
        f0 = torch.relu(self.conv0(x))
        f1 = torch.relu(self.conv1(x))
        if self.gate == "faithful":
            return to_nhwc(f0 * f0 + f1 * f1)
        s = (f0 + f1).mean(dim=(2, 3))                        # [N, C]
        a = self.sk(self.fc(s)).reshape(s.shape[0], 2, -1)
        a = torch.softmax(a.float(), dim=1).to(f0.dtype)[..., None, None]
        return to_nhwc(f0 * a[:, 0] + f1 * a[:, 1])


class SKNet(nn.Module):
    """Independent SKBlocks on the proposal and query streams."""

    def __init__(self, channels: int = 1024, gate: str = "faithful",
                 dtype=torch.float32):
        super().__init__()
        self.sk_props = SKBlock(channels, gate=gate, dtype=dtype)
        self.sk_query = SKBlock(channels, gate=gate, dtype=dtype)

    def forward(self, x_props, x_query):
        return self.sk_props(x_props), self.sk_query(x_query)
