"""Weights between the JAX package's param tree and the port's state_dict.

The JAX tree is a nested dict of numpy arrays, as
ait_tpu/train/state.py::init_params returns it.  Each port module names its
parameters after the JAX leaves, so a leaf maps by path, with the layout
change of ait_tpu/convert.py inverted:

* `Conv`: kernel [kh, kw, I, O] -> weight [O, I, kh, kw] (grouped convs
  carry I / groups, e.g. SKNet's [k, k, C/8, C] -> [C, C/8, k, k]);
* `Dense`: kernel [I, O] -> weight [O, I];
* `Params` (attention and FFN leaves, which the port computes as x @ w;
  the GroupNorm's `GroupNorm_0/{scale, bias}`; the GRU/LSTM's w_ih, w_hh,
  b_ih, b_hh) and `FrozenBatchNorm` {scale, bias, mean, var}: unchanged.

`to_state_dict` fails on any leaf left over on either side or of the wrong
shape; `to_jax_tree` is the reverse map, with the same refusals, from the
port's tensors (its state_dict, or its gradients via `grad_tree`) to the
JAX tree as numpy arrays, so the two packages' weights and gradients can be
compared leaf by leaf.  `jax_shapes` gives the tree's shapes from a port
module alone and `random_tree` fills such a tree from a numpy seed, so
random weights can be made without JAX and carried across like trained
ones.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from ait_tpu_torch.models.layers import Conv, Dense, FrozenBatchNorm, Params

Path = Tuple[str, ...]


def _conv_to_torch(k):
    return np.transpose(k, (3, 2, 0, 1))


def _conv_to_jax(w):
    return np.transpose(w, (2, 3, 1, 0))


# each layout change of `mappings` and its inverse
_TO_JAX = {_conv_to_torch: _conv_to_jax, np.transpose: np.transpose,
           None: None}


def _conv_shape(w):
    o, i, kh, kw = w.shape
    return (kh, kw, i, o)


def mappings(model: nn.Module) -> Iterator[Tuple[str, Path, tuple, object]]:
    """(state_dict key, JAX leaf path, JAX shape, JAX -> torch transform)."""
    for name, mod in model.named_modules():
        path = tuple(name.split(".")) if name else ()
        key = (name + ".") if name else ""
        if isinstance(mod, Conv):
            yield (key + "weight", path + ("kernel",),
                   _conv_shape(mod.weight), _conv_to_torch)
            if mod.bias is not None:
                yield (key + "bias", path + ("bias",), tuple(mod.bias.shape),
                       None)
        elif isinstance(mod, Dense):
            yield (key + "weight", path + ("kernel",),
                   tuple(mod.weight.shape[::-1]), np.transpose)
            yield key + "bias", path + ("bias",), tuple(mod.bias.shape), None
        elif isinstance(mod, (Params, FrozenBatchNorm)):
            leaves = dict(mod.named_parameters(recurse=False))
            leaves.update(mod.named_buffers(recurse=False))
            for leaf, t in leaves.items():
                yield key + leaf, path + (leaf,), tuple(t.shape), None


def _flatten(tree: dict, prefix: Path = ()) -> Dict[Path, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def nest(flat: Dict[Path, object]) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def jax_shapes(model: nn.Module) -> dict:
    """The JAX param tree's leaf shapes for this port module."""
    return nest({path: shape for _, path, shape, _ in mappings(model)})


def to_state_dict(model: nn.Module, params: dict) -> Dict[str, torch.Tensor]:
    """JAX param tree (nested dict of arrays) -> state_dict for `model`."""
    flat = _flatten(params)
    out: Dict[str, torch.Tensor] = {}
    missing, bad_shape = [], []
    for key, path, shape, fn in mappings(model):
        if path not in flat:
            missing.append("/".join(path))
            continue
        arr = np.asarray(flat.pop(path), np.float32)
        if arr.shape != shape:
            bad_shape.append(f"{'/'.join(path)}: {arr.shape} != {shape}")
            continue
        out[key] = torch.from_numpy(np.ascontiguousarray(
            fn(arr) if fn is not None else arr))
    unassigned = sorted(set(model.state_dict()) - set(out))
    problems = []
    if missing:
        problems.append(f"JAX leaves missing: {missing}")
    if bad_shape:
        problems.append(f"shape mismatches: {bad_shape}")
    if flat:
        problems.append(f"JAX leaves left over: "
                        f"{sorted('/'.join(p) for p in flat)}")
    if unassigned:
        problems.append(f"port entries without a JAX leaf: {unassigned}")
    if problems:
        raise ValueError("weight bridge: " + "; ".join(problems))
    return out


def to_jax_tree(model: nn.Module, tensors: Dict[str, torch.Tensor]) -> dict:
    """Port tensors keyed like model.state_dict() -> the JAX param tree
    (nested dict of float32 numpy arrays in the JAX layouts)."""
    left = dict(tensors)
    out = {}
    missing, bad_shape = [], []
    for key, path, shape, fn in mappings(model):
        if key not in left:
            missing.append(key)
            continue
        arr = left.pop(key).detach().float().cpu().numpy()
        back = _TO_JAX[fn]
        arr = np.ascontiguousarray(back(arr) if back is not None else arr)
        if arr.shape != shape:
            bad_shape.append(f"{key}: {arr.shape} != {shape}")
            continue
        out[path] = arr
    problems = []
    if missing:
        problems.append(f"port entries missing: {missing}")
    if bad_shape:
        problems.append(f"shape mismatches: {bad_shape}")
    if left:
        problems.append(f"port entries left over: {sorted(left)}")
    if problems:
        raise ValueError("weight bridge: " + "; ".join(problems))
    return nest(out)


def grad_tree(model: nn.Module) -> dict:
    """The parameters' gradients as a JAX-layout tree; a parameter without a
    gradient (frozen, or unused) and every buffer give zeros."""
    tensors = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
               for k, p in model.named_parameters()}
    keys = set(model.state_dict())
    tensors.update({k: torch.zeros_like(b)
                    for k, b in model.named_buffers() if k in keys})
    return to_jax_tree(model, tensors)


def random_tree(shapes: dict, seed: int) -> dict:
    """A JAX-layout param tree of float32 numpy arrays from `seed`.

    Kernels are normal with variance 1 / fan-in, biases small normals,
    LayerNorm, GroupNorm and FrozenBN scales near 1, BN means near 0 and
    variances in [0.5, 1.5], so activations stay finite through the
    full-width model; the contextual relation's GRU/LSTM leaves (w_ih,
    w_hh, b_ih, b_hh) uniform in +-1/sqrt(hidden), as `_RNNDirection`
    draws them (hidden = w_hh's first dimension)."""
    rng = np.random.default_rng(seed)
    flat = _flatten(shapes)
    out = {}
    for path in sorted(flat):
        shape = tuple(flat[path])
        leaf = path[-1]
        if leaf in ("w_ih", "w_hh", "b_ih", "b_hh"):
            hidden = flat[path[:-1] + ("w_hh",)][0]
            k = 1.0 / np.sqrt(hidden)
            a = rng.uniform(-k, k, shape)
        elif leaf == "kernel":
            fan_in = math.prod(shape[:-1])
            a = rng.standard_normal(shape, np.float32) / np.sqrt(fan_in)
        elif leaf == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(shape, np.float32)
        elif leaf == "var":
            a = rng.uniform(0.5, 1.5, shape)
        elif leaf in ("bias", "mean"):
            a = 0.05 * rng.standard_normal(shape, np.float32)
        else:
            raise ValueError(f"no init rule for leaf {'/'.join(path)}")
        out[path] = a.astype(np.float32)
    return nest(out)
