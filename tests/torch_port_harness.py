"""Shared set-up of the PyTorch-port parity tests (tests/test_torch_port_*).

Builds the JAX flagship and the port's detector from one numpy-seeded param
tree.  The JAX tree's shapes come from `jax.eval_shape(model.init, ...)`,
which costs seconds where an eager init of the full-width tiny flagship
costs close to a minute; the values come from `bridge.random_tree`.
Both sides compute in float32 on the CPU: the JAX package's
`platform_dependent` branches then take their jnp references, the port's
kernel wrappers their plain versions.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import __graft_entry__ as graft  # noqa: E402
from ait_tpu.models import AITDetector as JaxDetector  # noqa: E402
from ait_tpu_torch import bridge
from ait_tpu_torch.config import Config as PortConfig
from ait_tpu_torch.models import AITDetector as PortDetector
from ait_tpu_torch.models.targets import AnchorDraws, ProposalDraws

H, W, Q = 96, 128, 128        # tiny canvas and the real query size


def port_config(cfg) -> PortConfig:
    """The port's Config with the same values as a JAX Config."""
    def rebuild(template, values):
        kw = {}
        for f in dataclasses.fields(template):
            cur = getattr(template, f.name)
            v = values[f.name]
            kw[f.name] = rebuild(cur, v) if dataclasses.is_dataclass(cur) \
                else v
        return dataclasses.replace(template, **kw)

    return rebuild(PortConfig(), dataclasses.asdict(cfg))


def jax_shapes(module, *args, **kw):
    """{path: shape} tree of a flax module's params, without running init."""
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
            "sampling": jax.random.PRNGKey(2)}
    tree = jax.eval_shape(lambda: module.init(rngs, *args, **kw))["params"]
    return jax.tree_util.tree_map(lambda s: tuple(s.shape), tree)


def batch(b=2, seed=0):
    """uint8 canvases and queries, as the loader ships them, with a true
    image extent smaller than the canvas."""
    rng = np.random.RandomState(seed)
    image = rng.randint(0, 256, (b, H, W, 3)).astype(np.uint8)
    query = rng.randint(0, 256, (b, Q, Q, 3)).astype(np.uint8)
    im_info = np.tile(np.asarray([[H - 8, W - 16, 1.0]], np.float32), (b, 1))
    return image, query, im_info


@functools.lru_cache(maxsize=None)
def flagship(seed=0):
    """(jax cfg, jax model, params tree, port cfg, port model) at the tiny
    flagship's sizes, float32."""
    cfg, _ = graft._flagship(tiny=True)
    jmodel = JaxDetector(cfg, dtype=jnp.float32)
    g = graft._batch(1, H, W, g=cfg.MAX_NUM_GT_BOXES)
    shapes = jax_shapes(jmodel, g["image"], g["query"], g["im_info"],
                        g["gt_boxes"], g["num_boxes"], train=False)
    params = bridge.random_tree(shapes, seed)
    pcfg = port_config(cfg)
    pmodel = PortDetector(pcfg, dtype=torch.float32)
    pmodel.load_state_dict(bridge.to_state_dict(pmodel, params))
    pmodel.eval()
    return cfg, jmodel, params, pcfg, pmodel


def to_np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _as_torch(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def anchor_draws(key, b, n):
    """The uniforms ait_tpu's anchor_targets draws from `key` (the splits of
    targets.py:80-84, the draw of :52), vmapped over the images as there:
    under the `rbg` generator, which a module imported earlier in the same
    process may have made the default, a vmapped draw differs from a loop
    of single draws."""
    def one(k):
        k1, k2 = jax.random.split(k)
        return jax.random.uniform(k1, (n,)), jax.random.uniform(k2, (n,))

    return AnchorDraws(*_as_torch(*jax.vmap(one)(jax.random.split(key, b))))


def proposal_draws(key, b, n_p, r):
    """The uniforms ait_tpu's proposal_targets draws from `key` (targets.py
    :145, :151, :62, :172-173), vmapped as there."""
    def one(k):
        return tuple(jax.random.uniform(kk, (m,)) for kk, m in
                     zip(jax.random.split(k, 4), (n_p, n_p, r, r)))

    return ProposalDraws(*_as_torch(*jax.vmap(one)(jax.random.split(key, b))))


class BernoulliFeed:
    """Stands in for `jax.random.bernoulli` while JAX traces a train
    forward: hands out the keep-masks of `masks` in call order (one trace
    consumes all of them; the next trace starts over), checking each
    shape.  Under `jax.jit` the masks become constants of the trace.  With
    masks=None it records the shapes the trace asks for and keeps all."""

    def __init__(self, masks=None):
        self.masks = masks
        self.shapes = []
        self.i = 0

    def __call__(self, key, p=0.5, shape=None, *args, **kw):
        shape = tuple(shape)
        if self.masks is None:
            self.shapes.append(shape)
            return jnp.ones(shape, bool)
        m = self.masks[self.i % len(self.masks)]
        self.i += 1
        assert m.shape == shape, (self.i - 1, m.shape, shape)
        return jnp.asarray(m)


def keep_masks(shapes, keep_prob, seed):
    """numpy bool keep-masks of Bernoulli(keep_prob), one per shape."""
    rng = np.random.RandomState(seed)
    return [rng.rand(*s) < keep_prob for s in shapes]
