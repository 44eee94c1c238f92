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
1, padding (2, 1); the 4x4 kernel is derived from `conv1` at each forward
(once where the pair folds: `layers.frozen_consts`).

Where autograd does not record (eval, `inference_mode`, `no_grad`) and the
convolutions compute in bfloat16, every conv + FrozenBN pair runs as one
convolution on its folded kernel and bias, built once and kept on the
device (`layers.conv_bn`); training, and float32, run the pairs unfolded.

Public functions take and return NHWC tensors; inside, the convolutions run
NCHW-shaped in the channels_last memory format.

Also here: `ContextualRelation`, the optional GRU/LSTM branch over the
query's stage features (resnet.py:149-238), and `fold_frozen_bn`, the
eval-time fold of every FrozenBN into its conv (resnet.py:264-304).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ait_tpu_torch.models.layers import (Conv, Dense, FrozenBatchNorm, Params,
                                         conv_bn, folds, frozen_consts,
                                         max_pool_ceil, to_nchw, to_nhwc,
                                         uniform_init)

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
        y = torch.relu(conv_bn(self.conv1, self.bn1, x))
        y = torch.relu(conv_bn(self.conv2, self.bn2, y))
        y = conv_bn(self.conv3, self.bn3, y)
        residual = x
        if self.downsample:
            residual = conv_bn(self.downsample_conv, self.downsample_bn, x)
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

    def stem_bn(self, x):
        """bn1(stem(x)), as `layers.conv_bn` runs a pair: folded, one
        convolution on the cached kernel in the input's form."""
        if not folds(self.conv1):
            return self.bn1(self.stem(x))
        if x.shape[1] != 12:
            return conv_bn(self.conv1, self.bn1, x)
        kernel, bias = frozen_consts(self.conv1, self.bn1, s2d_stem_weight)
        return F.conv2d(F.pad(x.to(self.conv1.dtype), (2, 1, 2, 1)), kernel,
                        bias)

    def forward(self, x, return_stages: bool = False):
        """[B, H, W, 3], or its space-to-depth form [B, H/2, W/2, 12], ->
        [B, H/16, W/16, 1024]; with return_stages also (layer1, layer2,
        layer3)'s outputs, NHWC."""
        x = torch.relu(self.stem_bn(to_nchw(x)))
        x = max_pool_ceil(x, 3, 2)
        x1 = self.layer1(x)
        x2 = self.layer2(x1)
        x3 = to_nhwc(self.layer3(x2))
        if return_stages:
            return x3, (to_nhwc(x1), to_nhwc(x2), x3)
        return x3


class _RNNDirection(Params):
    """One direction of a torch-layout GRU (gates r, z, n) or LSTM (i, f, g,
    o) over a short sequence, float32 (resnet.py:149-195); the leaves in the
    JAX layout: w_ih [D, G*H], w_hh [H, G*H], b_ih, b_hh [G*H]."""

    def __init__(self, d: int, hidden: int, method: str = "GRU",
                 reverse: bool = False):
        g = 3 if method == "GRU" else 4
        unif = uniform_init(1.0 / hidden ** 0.5)       # resnet.py:164-173
        super().__init__(w_ih=((d, g * hidden), unif),
                         w_hh=((hidden, g * hidden), unif),
                         b_ih=((g * hidden,), unif),
                         b_hh=((g * hidden,), unif))
        if method not in ("GRU", "LSTM"):
            raise ValueError(f"rnn method {method}")
        self.hidden, self.method, self.reverse = hidden, method, reverse

    def forward(self, xs):                        # [B, S, D] float32
        b, steps = xs.shape[0], xs.shape[1]
        h = xs.new_zeros(b, self.hidden)
        c = xs.new_zeros(b, self.hidden)
        outs = [None] * steps
        order = range(steps - 1, -1, -1) if self.reverse else range(steps)
        for t in order:
            gi = xs[:, t, :] @ self.w_ih + self.b_ih
            gh = h @ self.w_hh + self.b_hh
            if self.method == "GRU":
                ir, iz, in_ = gi.chunk(3, dim=-1)
                hr, hz, hn = gh.chunk(3, dim=-1)
                r = torch.sigmoid(ir + hr)
                z = torch.sigmoid(iz + hz)
                n = torch.tanh(in_ + r * hn)
                h = (1.0 - z) * n + z * h
            else:
                i, f, g_, o = (gi + gh).chunk(4, dim=-1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g_)
                h = torch.sigmoid(o) * torch.tanh(c)
            outs[t] = h
        return torch.stack(outs, dim=1)           # [B, S, H]


class ContextualRelation(nn.Module):
    """The recurrent excitation branch (resnet.py:198-238): each stage
    feature 1x1-conv embedded to `channels` and spatially averaged, the
    three as a sequence through a (bidirectional) GRU or LSTM of hidden size
    channels // reduction in f32; the last step through fc + sigmoid gives a
    per-channel scale [B, channels] f32."""

    def __init__(self, channels: int = 2048, reduction: int = 16,
                 rnn_layers: int = 1, bidirectional: bool = True,
                 method: str = "GRU", dtype=torch.float32):
        super().__init__()
        # layer1..3's outputs of every bottleneck ResNet
        for i, cin in enumerate((256, 512, 1024)):
            self.add_module(f"trans{i + 1}", Conv(cin, channels, 1,
                                                  dtype=dtype))
        hidden = channels // reduction
        d = channels
        for layer in range(rnn_layers):
            self.add_module(f"l{layer}_fw",
                            _RNNDirection(d, hidden, method))
            if bidirectional:
                self.add_module(f"l{layer}_bw",
                                _RNNDirection(d, hidden, method, True))
            d = hidden * (2 if bidirectional else 1)
        self.fc = Dense(d, channels)
        self.rnn_layers, self.bidirectional = rnn_layers, bidirectional

    def forward(self, stages):
        seq = []
        for i, x in enumerate(stages):
            y = getattr(self, f"trans{i + 1}")(to_nchw(x))
            seq.append(y.mean(dim=(2, 3)))
        out = torch.stack(seq, dim=1).float()              # [B, 3, C]
        for layer in range(self.rnn_layers):
            fw = getattr(self, f"l{layer}_fw")(out)
            if self.bidirectional:
                bw = getattr(self, f"l{layer}_bw")(out)
                out = torch.cat([fw, bw], dim=-1)
            else:
                out = fw
        return torch.sigmoid(self.fc(out[:, -1, :]))       # [B, C] f32


class ResNetTop(nn.Module):
    """layer4 + global spatial mean: [N, h, w, 1024] -> [N, 2048]."""

    def __init__(self, variant: str = "resnet50", dtype=torch.float32):
        super().__init__()
        self.layer4 = ResNetStage(1024, 512, STAGES[variant][3], 2, dtype)

    def forward(self, x):
        return self.layer4(to_nchw(x)).mean(dim=(2, 3))


# ---------------------------------------------------------------------------
# Eval-time constant folding
# ---------------------------------------------------------------------------

_BN_OF_CONV = {"conv1": "bn1", "conv2": "bn2", "conv3": "bn3",
               "downsample_conv": "downsample_bn"}


def fold_frozen_bn(state_dict: Dict[str, torch.Tensor],
                   eps: float = 1e-5) -> Dict[str, torch.Tensor]:
    """A copy of a detector's state_dict with every FrozenBatchNorm folded
    into its conv (resnet.py:268-304), on the host in f32: each paired
    conv's weight [O, I, kh, kw] scaled by w = scale * rsqrt(var + eps) per
    output channel, the BN rewritten to scale 1, var 1 - eps (so
    rsqrt((1 - eps) + eps) = 1 in f32), mean 0, bias b - m * w.  The module
    code is unchanged; with layers.BN_BIAS_ONLY set the program then adds
    only the biases.  Eval only: a folded kernel trains on another
    parameterisation."""
    out = {k: v.detach().cpu().float().clone() if v.is_floating_point()
           else v.clone() for k, v in state_dict.items()}
    for key in state_dict:
        for ck, bk in _BN_OF_CONV.items():
            suffix = f"{ck}.weight"
            if key != suffix and not key.endswith("." + suffix):
                continue
            prefix = key[:-len(suffix)]
            if prefix + bk + ".var" not in out:
                continue
            scale, var = out[prefix + bk + ".scale"], out[prefix + bk + ".var"]
            mean, bias = out[prefix + bk + ".mean"], out[prefix + bk + ".bias"]
            w = scale * torch.rsqrt(var + eps)
            out[key] = out[key] * w[:, None, None, None]
            out[prefix + bk + ".scale"] = torch.ones_like(scale)
            out[prefix + bk + ".var"] = torch.full_like(var, 1.0 - eps)
            out[prefix + bk + ".mean"] = torch.zeros_like(mean)
            out[prefix + bk + ".bias"] = bias - mean * w
    return out
