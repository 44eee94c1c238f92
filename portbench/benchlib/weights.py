"""Seeded weights of the AIT detector, made on the device in a few calls.

Each leaf is drawn from the initializer that the model's published JAX/flax
code declares for it (the frozen table in `init_of`): lecun-normal kernels
(flax's default, a normal truncated at two sigma), xavier-uniform for the
transformer's and attention's kernels, N(0, 0.01) for the RPN and the match
head, N(0, 0.001) for the box head, a truncated Kaiming (fan out) for SKNet,
zero biases, and identity FrozenBN statistics.  So proposal scores look as
they do at the start of training.

Keys and layouts are those of the program's `state_dict` (convolution
kernels [O, I/g, kh, kw], dense weights [O, I], attention and FFN kernels
[in, out]), which the reference reads too.  All uniforms come from one
`torch.rand` and all normals from one `torch.randn` on a generator of the
device, so a seed gives the same weights on any run.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

TRUNC_STD = 0.87962566103423978     # std of N(0, 1) truncated to [-2, 2]
BN_NAMES = ("bn1", "bn2", "bn3", "downsample_bn")


def _fans(key: str, shape) -> Tuple[int, int]:
    """(fan_in, fan_out) as flax computes them on the JAX layout."""
    if len(shape) == 4:                         # conv [O, I/g, kh, kw]
        rf = shape[2] * shape[3]
        return shape[1] * rf, shape[0] * rf
    if key.endswith(".kernel"):                 # raw [in, out]
        return shape[0], shape[1]
    return shape[1], shape[0]                   # dense [O, I]


def init_of(key: str, shape) -> Tuple[str, float]:
    """(kind, scale) of a leaf: ("zeros" | "ones", 0), ("normal", std),
    ("trunc", std) or ("uniform", bound)."""
    parts = key.split(".")
    leaf, parent = parts[-1], parts[-2]
    if parent in BN_NAMES:
        return ("ones", 0.0) if leaf in ("scale", "var") else ("zeros", 0.0)
    if parent in ("LayerNorm_0", "enc_in_ln", "dec_in_ln"):
        return ("ones", 0.0) if leaf == "scale" else ("zeros", 0.0)
    if leaf == "bias":
        return ("zeros", 0.0)
    fan_in, fan_out = _fans(key, shape)
    if parts[0] == "rpn" or parts[0] in ("cls_score_0", "cls_score_1"):
        return ("normal", 0.01)
    if parts[0] == "bbox_pred_head":
        return ("normal", 0.001)
    if parts[0] == "sk":
        return ("trunc", math.sqrt(2.0 / fan_out))
    xavier = (parts[0] == "transformer" and parent in (
        "enc_emb", "dec_emb", "dec_trans")) or parent in (
        "w_qs", "w_ks", "w_vs", "fc", "w_1", "w_2")
    if xavier:
        return ("uniform", math.sqrt(6.0 / (fan_in + fan_out)))
    return ("trunc", math.sqrt(1.0 / fan_in))


def make_weights(shapes: Dict[str, Tuple[int, ...]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """{key: float32 tensor on `device`} for the leaves `shapes` names."""
    keys = sorted(shapes)
    kinds = {k: init_of(k, shapes[k]) for k in keys}
    n_unif = sum(math.prod(shapes[k]) for k in keys
                 if kinds[k][0] in ("trunc", "uniform"))
    n_norm = sum(math.prod(shapes[k]) for k in keys
                 if kinds[k][0] == "normal")
    g = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    unif = torch.rand(n_unif, generator=g, device=device)
    norm = torch.randn(n_norm, generator=g, device=device)
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    out, iu, inn = {}, 0, 0
    for k in keys:
        kind, scale = kinds[k]
        shape = shapes[k]
        n = math.prod(shape)
        if kind == "zeros":
            out[k] = torch.zeros(shape, device=device)
        elif kind == "ones":
            out[k] = torch.ones(shape, device=device)
        elif kind == "normal":
            out[k] = norm[inn:inn + n].view(shape) * scale
            inn += n
        else:
            u = unif[iu:iu + n].view(shape)
            iu += n
            if kind == "uniform":
                out[k] = (u * 2.0 - 1.0) * scale
            else:
                z = math.sqrt(2.0) * torch.erfinv(lo + (hi - lo) * u)
                out[k] = z.clamp(-2.0, 2.0) * (scale / TRUNC_STD)
    return out
