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

Each module also declares, in `inits`, the initializer that ait_tpu declares
for each of its leaves (flax's, counterparts below: an initializer is
`init(generator, shape) -> float32 tensor` over the leaf's JAX-layout shape,
so fans are flax's: a kernel is [..., in, out], a grouped conv's `in` is its
channels per group).  `train.state.init_params` draws every leaf from it.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ait_tpu_torch.utils.profiling import count

Init = Callable[[torch.Generator, Tuple[int, ...]], torch.Tensor]

# flax's truncated-normal variance scaling divides the stddev by the std of a
# standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def zeros_init(generator: torch.Generator, shape) -> torch.Tensor:
    """flax nn.initializers.zeros."""
    return torch.zeros(shape)


def ones_init(generator: torch.Generator, shape) -> torch.Tensor:
    """flax nn.initializers.ones."""
    return torch.ones(shape)


def normal_init(stddev: float = 1e-2) -> Init:
    """flax nn.initializers.normal(stddev): N(0, stddev^2)."""
    def init(generator, shape):
        return torch.randn(shape, generator=generator) * stddev
    return init


def uniform_init(bound: float) -> Init:
    """U[-bound, bound) (the GRU/LSTM leaves' `unif`, resnet.py:166-167)."""
    def init(generator, shape):
        return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound
    init.bound = lambda shape: bound
    return init


def _fans(shape) -> Tuple[float, float]:
    """flax's _compute_fans: in axis -2, out axis -1, the rest receptive."""
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def truncated_normal(generator: torch.Generator, shape) -> torch.Tensor:
    """A standard normal truncated to [-2, 2], by the inverse CDF as
    jax.random.truncated_normal draws it."""
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = lo + (hi - lo) * torch.rand(shape, generator=generator)
    return (math.sqrt(2.0) * torch.erfinv(u)).clamp_(-2.0, 2.0)


def variance_scaling(scale: float, mode: str, distribution: str) -> Init:
    """flax nn.initializers.variance_scaling: variance scale / fan, with fan
    fan_in, fan_out or their mean; a normal truncated at +-2 sigma and
    rescaled by 1 / 0.8796..., a normal, or a uniform of that variance."""
    if mode not in ("fan_in", "fan_out", "fan_avg"):
        raise ValueError(f"variance_scaling mode {mode!r}")
    if distribution not in ("truncated_normal", "normal", "uniform"):
        raise ValueError(f"variance_scaling distribution {distribution!r}")

    def std(shape) -> float:
        fan_in, fan_out = _fans(shape)
        fan = {"fan_in": fan_in, "fan_out": fan_out,
               "fan_avg": (fan_in + fan_out) / 2.0}[mode]
        return math.sqrt(scale / fan)

    def init(generator, shape):
        if distribution == "truncated_normal":
            return truncated_normal(generator, shape) * \
                (std(shape) / _TRUNC_STD)
        if distribution == "normal":
            return torch.randn(shape, generator=generator) * std(shape)
        return ((torch.rand(shape, generator=generator) * 2.0 - 1.0) *
                (math.sqrt(3.0) * std(shape)))

    def bound(shape) -> float:
        """The largest |value| a draw can take."""
        if distribution == "truncated_normal":
            return 2.0 * std(shape) / _TRUNC_STD
        if distribution == "uniform":
            return math.sqrt(3.0) * std(shape)
        return math.inf

    init.bound = bound
    return init


def lecun_normal() -> Init:
    """flax nn.initializers.lecun_normal (nn.Conv's and nn.Dense's default
    kernel init)."""
    return variance_scaling(1.0, "fan_in", "truncated_normal")


def xavier_uniform() -> Init:
    """flax nn.initializers.xavier_uniform."""
    return variance_scaling(1.0, "fan_avg", "uniform")


class Params(nn.Module):
    """Raw parameter leaves in the JAX layout, each with its initializer
    (ait_tpu's `_P`): Params(kernel=((512, 512), xavier_uniform()))."""

    def __init__(self, **leaves: Tuple[Tuple[int, ...], Init]):
        super().__init__()
        self.inits: Dict[str, Init] = {}
        for name, (shape, init) in leaves.items():
            self.register_parameter(
                name, nn.Parameter(torch.zeros(shape)))
            self.inits[name] = init


def layer_norm_params(d: int) -> Params:
    """A LayerNorm's leaves: scale ones, bias zeros."""
    return Params(scale=((d,), ones_init), bias=((d,), zeros_init))


class Conv(nn.Module):
    """flax nn.Conv with an explicit symmetric padding, on NCHW tensors;
    kernel lecun_normal unless given, bias zeros, as flax's defaults."""

    def __init__(self, cin: int, cout: int, k: int, *, stride: int = 1,
                 padding: int = 0, groups: int = 1, bias: bool = True,
                 dtype=torch.float32, kernel_init: Init = None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride, self.padding, self.groups = stride, padding, groups
        self.dtype = dtype
        self.inits = {"kernel": kernel_init or lecun_normal()}
        if bias:
            self.inits["bias"] = zeros_init

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), b,
                        self.stride, self.padding, 1, self.groups)


class Dense(nn.Module):
    """flax nn.Dense over the last axis; kernel lecun_normal unless given,
    bias zeros."""

    def __init__(self, cin: int, cout: int, dtype=torch.float32,
                 kernel_init: Init = None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dtype = dtype
        self.inits = {"kernel": kernel_init or lecun_normal(),
                      "bias": zeros_init}

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
        self.inits = {"scale": ones_init, "bias": zeros_init,
                      "mean": zeros_init, "var": ones_init}
        for name, init in self.inits.items():
            self.register_buffer(name, init(None, (features,)))
        self.eps = eps

        # conv_bn's folded constants, by kernel form: plain attributes, so
        # state_dict() and the weight bridge never see them
        self.folded: Dict[object, tuple] = {}

    def forward(self, x):
        w = self.scale * torch.rsqrt(self.var + self.eps)
        b = self.bias - self.mean * w
        if BN_BIAS_ONLY:
            return x + b.to(x.dtype)[None, :, None, None]
        return (x * w.to(x.dtype)[None, :, None, None] +
                b.to(x.dtype)[None, :, None, None])


def frozen_consts(conv: Conv, bn: FrozenBatchNorm,
                  form: Callable = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(kernel, bias) of a bias-free conv followed by its FrozenBatchNorm
    as one convolution: the kernel scaled per output channel by
    w = scale * rsqrt(var + eps) in f32, as models.resnet.fold_frozen_bn
    folds it (unscaled under BN_BIAS_ONLY, as the BN then ignores w), then
    given `form` (the stem's space-to-depth kernel) and cast to conv's
    dtype; the bias b = bias - mean * w in conv's dtype.

    Cached on `bn` per form, and built again only when a source tensor
    changes: the key is each source's storage and version counter (an
    in-place optimizer step, load_state_dict, `.to()` or the fold each move
    one), conv's dtype and BN_BIAS_ONLY.  An entry keeps its sources'
    storage alive, so no other tensor can take their addresses.  Counted
    as `frozen_consts.built` or `frozen_consts.reused`."""
    src = (conv.weight, bn.scale, bn.var, bn.mean, bn.bias)
    try:
        key = (tuple((t.data_ptr(), t._version) for t in src),
               conv.weight.device, conv.dtype, BN_BIAS_ONLY)
    except RuntimeError:      # inference tensors keep no version: no cache
        key = None
    entry = bn.folded.get(form)
    if key is not None and entry is not None and entry[0] == key:
        count("frozen_consts.reused")
        return entry[1], entry[2]
    count("frozen_consts.built")
    with torch.no_grad():
        w = bn.scale * torch.rsqrt(bn.var + bn.eps)
        kernel = conv.weight if BN_BIAS_ONLY else \
            conv.weight * w[:, None, None, None]
        if form is not None:
            kernel = form(kernel)
        kernel = kernel.to(conv.dtype)
        bias = (bn.bias - bn.mean * w).to(conv.dtype)
    if key is not None:
        bn.folded[form] = (key, kernel, bias, tuple(t.detach() for t in src))
    return kernel, bias


def folds(conv: Conv) -> bool:
    """Whether `conv_bn` runs conv's pair folded: with autograd off and
    conv computing in a dtype narrower than the BN's float32 constants.
    Where autograd records, training trains the unfolded parameterisation.
    In float32 the fold would only reorder f32 roundings, and the unfolded
    f32 program is the one held to ait_tpu's.  In bfloat16 it drops two of
    the pair's three roundings and both passes over the activations."""
    return not torch.is_grad_enabled() and torch.finfo(conv.dtype).bits < 32


def conv_bn(conv: Conv, bn: FrozenBatchNorm, x):
    """bn(conv(x)); where `folds(conv)`, one convolution on the constants of
    `frozen_consts`, which no batch rebuilds."""
    if not folds(conv):
        return bn(conv(x))
    kernel, bias = frozen_consts(conv, bn)
    return F.conv2d(x.to(conv.dtype), kernel, bias, conv.stride,
                    conv.padding, 1, conv.groups)


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
        self.GroupNorm_0 = Params(scale=((features,), zeros_init),
                                  bias=((features,), zeros_init))

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

