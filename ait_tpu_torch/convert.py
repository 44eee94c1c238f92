"""Converted weights onto a port model (counterpart of ait_tpu/convert.py,
`load_pretrained` only; the converters from a reference `.pth` are
ROADMAP A14).

The input is the pickle `tools/convert_torch_checkpoint.py` writes: a
nested dict of numpy arrays in the JAX package's param layout, the whole
detector's tree or a part of it (a backbone-only pretrain).  The layout
changes to the port's tensors are the weight bridge's (`bridge.mappings`).
The pickle is read by an unpickler that builds only builtins and numpy
arrays.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from ait_tpu_torch import bridge
from ait_tpu_torch.data.coco import read_data_pickle


def _overlay(shapes: dict, loaded: dict, prefix: tuple,
             out: Dict[tuple, np.ndarray]) -> None:
    """Walk the pickle's tree against the model's JAX-layout shapes, as
    ait_tpu.convert.load_pretrained does: keys the model lacks are skipped,
    a subtree against a leaf (or the reverse) or a wrong shape raises."""
    for k, v in loaded.items():
        if k not in shapes:
            continue
        path = prefix + (k,)
        name = "/".join(path)
        if isinstance(v, dict):
            if not isinstance(shapes[k], dict):
                raise ValueError(
                    f"structure mismatch at '{name}': the pickle has a "
                    f"subtree but the model has a leaf {shapes[k]}")
            _overlay(shapes[k], v, path, out)
            continue
        if isinstance(shapes[k], dict):
            raise ValueError(
                f"structure mismatch at '{name}': the pickle has a leaf "
                f"{np.shape(v)} but the model has a subtree")
        if tuple(np.shape(v)) != tuple(shapes[k]):
            raise ValueError(f"shape mismatch at '{name}': the pickle has "
                             f"{np.shape(v)}, the model {shapes[k]}")
        out[path] = np.asarray(v, np.float32)


def load_pretrained(model: nn.Module, path: str) -> int:
    """Overlay a converted params pickle onto `model` in place; returns
    the number of arrays loaded."""
    loaded = read_data_pickle(path)
    if not isinstance(loaded, dict):
        raise ValueError(f"{path}: a params pickle holds a nested dict, "
                         f"not {type(loaded).__name__}")
    found: Dict[tuple, np.ndarray] = {}
    _overlay(bridge.jax_shapes(model), loaded, (), found)
    state = model.state_dict()
    with torch.no_grad():
        for key, leaf, _, fn in bridge.mappings(model):
            if leaf in found:
                arr = found[leaf]
                t = state[key]
                t.copy_(torch.from_numpy(np.ascontiguousarray(
                    fn(arr) if fn is not None else arr)).to(t.device,
                                                            t.dtype))
    return len(found)
