"""The port's initialization (`train.init_params`, models/layers.py's
initializers) against the tree that ait_tpu.train.init_params returns, leaf
by leaf, for the tiny flagship, the COCO recipe (non-local co-attention)
and the VGG16 recipe (at the train test's 64x64 queries).

ait_tpu's init_params runs here with its model's `init` under jax.jit (an
eager flax init costs about a minute a model); each recipe's tree is built
once per module.  The two packages draw from different generators, so the
checks are of the law each leaf is drawn from:

* the same paths, shapes and dtypes;
* a leaf that is all zeros or all ones in JAX is exactly that in the port;
* every value of a uniform or truncated leaf inside flax's bound (JAX's
  values inside the port's bound, and for >= 4096 values reaching 90% of
  it, so the bound is flax's);
* for leaves of >= 4096 values, the standard deviation within 5% of JAX's
  and the mean within 4 standard errors of JAX's;
* one seed gives the same weights twice, two seeds different ones.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_harness as harness
import __graft_entry__ as graft
from ait_tpu.models import AITDetector as JaxDetector
from ait_tpu.train import init_params as jax_init_params
from ait_tpu_torch import bridge
from ait_tpu_torch.models import AITDetector
from ait_tpu_torch.models.ait_transformer import AITTransformer
from ait_tpu_torch.train import init_module, init_params

BIG = 4096
RECIPES = {
    "flagship": dict(),
    "coco": dict(model={"coattention": "nonlocal"},
                 top={"ANCHOR_SCALES": (4, 8, 16, 32)}),
    "vgg16": dict(model={"backbone": "vgg16", "channels": 512},
                  train={"query_size": 64}, top={"POOLING_SIZE": 3}),
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on the CPU's
    cores, and each torch process would otherwise start one a core."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _config(recipe):
    cfg, _ = graft._flagship(tiny=True)
    spec = RECIPES[recipe]
    return cfg.replace(
        model=dataclasses.replace(cfg.model, **spec.get("model", {})),
        TRAIN=dataclasses.replace(cfg.TRAIN, **spec.get("train", {})),
        **spec.get("top", {}))


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


@functools.lru_cache(maxsize=None)
def trees(recipe):
    """(JAX tree, port tree, {path: the port's initializer}) of a recipe;
    both from seed 3, the CLIs' RNG_SEED."""
    cfg = _config(recipe)
    jm = JaxDetector(cfg, dtype=jnp.float32)
    object.__setattr__(jm, "init", jax.jit(
        functools.partial(JaxDetector.init, jm), static_argnames="train"))
    jtree = _flat(jax_init_params(jm, cfg, jax.random.PRNGKey(3)))
    pcfg = harness.port_config(cfg)
    pm = init_params(AITDetector(pcfg), pcfg, 3)
    ptree = _flat(bridge.to_jax_tree(pm, pm.state_dict()))
    inits = {}
    for name, mod in pm.named_modules():
        path = tuple(name.split(".")) if name else ()
        for leaf, init in getattr(mod, "inits", {}).items():
            inits[path + (leaf,)] = init
    return jtree, ptree, inits


@pytest.fixture(scope="module", params=sorted(RECIPES))
def recipe(request):
    return (request.param,) + trees(request.param)


def test_same_paths_shapes_and_dtypes(recipe):
    _, jtree, ptree, _ = recipe
    assert sorted(jtree) == sorted(ptree)
    for path, j in jtree.items():
        assert ptree[path].shape == j.shape, path
        assert ptree[path].dtype == j.dtype == np.float32, path


def test_constant_leaves_equal(recipe):
    _, jtree, ptree, _ = recipe
    n = 0
    for path, j in jtree.items():
        for c in (0.0, 1.0):
            if np.all(j == c):
                np.testing.assert_array_equal(ptree[path], j,
                                              err_msg="/".join(path))
                n += 1
    assert n > 0


def test_values_inside_flax_bounds(recipe):
    _, jtree, ptree, inits = recipe
    n = 0
    for path, j in jtree.items():
        bound = getattr(inits[path], "bound", None)
        if bound is None or not math.isfinite(bound(j.shape)):
            continue
        b = bound(j.shape)
        assert np.abs(ptree[path]).max() <= b, path
        assert np.abs(j).max() <= b * (1 + 1e-6), path
        if j.size >= BIG:
            assert np.abs(j).max() >= 0.9 * b, path
        n += 1
    assert n > 0


def test_large_leaves_drawn_from_the_same_law(recipe):
    _, jtree, ptree, _ = recipe
    n = 0
    for path, j in jtree.items():
        if j.size < BIG or np.all(j == j.flat[0]):
            continue
        p = ptree[path].astype(np.float64)
        j = j.astype(np.float64)
        sj, sp = j.std(), p.std()
        assert abs(sp - sj) <= 0.05 * sj, (path, sp, sj)
        se = math.sqrt(sp ** 2 / p.size + sj ** 2 / j.size)
        assert abs(p.mean() - j.mean()) <= 4 * se, (path, p.mean(), j.mean())
        n += 1
    assert n > 0


def test_seeds():
    """init_params again from seed 3 gives the flagship's tree again;
    init_module (what it draws with) from seeds 0 and 1 on the AIT head
    gives other draws, and the same constants."""
    _, ptree, _ = trees("flagship")
    cfg = harness.port_config(_config("flagship"))
    pm = init_params(AITDetector(cfg), cfg, 3)
    again = _flat(bridge.to_jax_tree(pm, pm.state_dict()))
    assert all(np.array_equal(again[k], ptree[k]) for k in ptree)
    a, c = (init_module(AITTransformer(), seed).state_dict()
            for seed in (0, 1))
    drawn = [k for k in a if a[k].unique().numel() > 1]
    assert drawn and all(not torch.equal(a[k], c[k]) for k in drawn)
    assert all(torch.equal(a[k], c[k]) for k in a if k not in drawn)


def test_cfg_must_be_the_models():
    cfg = harness.port_config(_config("flagship"))
    other = cfg.replace(RNG_SEED=cfg.RNG_SEED + 1)
    with pytest.raises(ValueError, match="not the model's config"):
        init_params(AITDetector(cfg), other, 0)
