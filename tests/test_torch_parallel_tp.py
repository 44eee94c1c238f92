"""Tensor parallelism of the port (ait_tpu_torch/parallel/tp.py and the
tp branches of models/attention.py) on gloo process groups of the CPU.

* Against the JAX package on its virtual 8-device mesh (tests/test_tp.py's
  tiny transformer, 4 heads, d_inner 64, over a 'model' axis of 2): the
  forward within 2e-5, and every parameter's gradient of sum(out^2), after
  tp_psum_grads on both sides, within 5e-5 of its leaf's max |JAX|;
  the block-sparse leaves that tp_psum_grads sums are JAX's, name by name.
* Port against port on the tiny flagship: one train step on a (data 1 x
  model 2) mesh against the world-1 make_train_step on the same weights,
  batch and generator, at t_dropout 0 and 0.1 (each rank draws the
  unsharded model's dropout masks and keeps its heads): losses within 1e-4
  relative, every parameter within 1e-4 relative plus 1e-4 of max(1e-3,
  its leaf's max |plain|) (tests/test_tp.py:135-142's allclose), the
  ranks' parameters bitwise equal.  Two images: on one image of this
  seed a ReLU of top.layer4 falls within f32 rounding of 0 and takes the
  other branch in one of the two runs (one output channel's gradient
  7.7e-3 off, every other within 1.5e-6), the tie that
  tests/test_torch_train_step.py describes.
* Sizes the heads cannot split, or a tp size without its mesh, are refused.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import torch_parallel_workers as workers
from ait_tpu.models.ait_transformer import AITTransformer as JaxTransformer
from ait_tpu.parallel import make_mesh
from ait_tpu.parallel.sharded import shard_map
from ait_tpu.parallel.tp import is_tp_leaf as jax_is_tp_leaf
from ait_tpu.parallel.tp import tp_psum_grads as jax_tp_psum_grads
from ait_tpu_torch import bridge
from ait_tpu_torch.models import AITDetector
from ait_tpu_torch.models.ait_transformer import AITTransformer
from ait_tpu_torch.parallel.tp import is_tp_leaf

TP = 2


def _jax_transformer(tp_size):
    return JaxTransformer(n_layers=1, dropout=0.1, channels=64,
                          d_word_vec=32, d_model=32, d_inner=64, n_head=4,
                          d_k=8, d_v=8, n_position=16, tp_size=tp_size,
                          tp_axis="model")


@functools.lru_cache()
def _setup():
    r = np.random.RandomState(0)
    props = r.randn(4, 3, 3, 64).astype(np.float32)   # 2 rois x 2 images
    query = r.randn(2, 4, 4, 64).astype(np.float32)
    port = AITTransformer(d_model=32, d_inner=64, n_layers=1, n_head=4,
                          d_k=8, d_v=8, n_position=16, channels=64)
    params = bridge.random_tree(bridge.jax_shapes(port), 0)
    state = {k: v.numpy()
             for k, v in bridge.to_state_dict(port, params).items()}
    return props, query, port, params, state


@pytest.fixture(scope="module")
def transformer():
    props, query, port, params, state = _setup()
    mesh = make_mesh(TP, axes=("model",))

    def fwd(p, a, b):
        return _jax_transformer(TP).apply({"params": p}, a, b,
                                          deterministic=True)

    def grads(p, a, b):
        def loss(p):
            return jnp.sum(fwd(p, a, b).astype(jnp.float32) ** 2)

        return jax_tp_psum_grads(jax.grad(loss)(p), "model")

    specs = dict(in_specs=(P(), P(), P()), out_specs=P())
    want = jax.jit(shard_map(fwd, mesh, **specs))(params, props, query)
    g_want = jax.jit(shard_map(grads, mesh, **specs))(params, props, query)
    ranks = workers.run(workers.tp_transformer, TP, state, props, query)
    return np.asarray(want), bridge.to_state_dict(port, g_want), ranks


def test_tp_transformer_forward_matches_jax(transformer):
    want, _, ranks = transformer
    for out, _ in ranks:
        np.testing.assert_allclose(out, want, rtol=2e-5, atol=2e-5)


def test_tp_grads_match_jax_every_leaf(transformer):
    _, g_want, ranks = transformer
    for _, grads in ranks:
        assert sorted(grads) == sorted(g_want)
        for k, a in g_want.items():
            a = a.numpy()
            scale = max(1.0, float(np.abs(a).max()))
            np.testing.assert_allclose(grads[k], a, rtol=5e-5,
                                       atol=5e-5 * scale, err_msg=k)


def test_tp_leaves_are_jax_leaves():
    """Name by name over the flagship detector: the port sums exactly the
    leaves JAX's TP_PSUM_SUFFIXES select."""
    model = AITDetector(workers.tiny_cfg())
    n = 0
    for name, path, _, _ in bridge.mappings(model):
        keys = [jax.tree_util.DictKey(p) for p in path]
        assert is_tp_leaf(name) == jax_is_tp_leaf(keys), name
        n += is_tp_leaf(name)
    # 5 attentions x 5 leaves + 2 FFNs x 3
    assert n == 5 * 5 + 2 * 3


@pytest.fixture(scope="module")
def tp_steps():
    return workers.run(workers.tp_detector, TP, (0.0, 0.1))[0]


@pytest.mark.parametrize("t_dropout", [0.0, 0.1])
def test_tp_detector_step_matches_world1(tp_steps, t_dropout):
    metrics, errs, replicated = tp_steps[t_dropout]
    assert replicated
    for k, (got, want) in metrics.items():
        assert np.isfinite(got) and abs(got - want) <= 1e-4 * abs(want), k
    bad = {k: e for k, e in errs.items() if e > 1e-4}
    assert not bad, bad


def test_tp_sizes_refused():
    with pytest.raises(ValueError, match=r"tpu.tp_size 3 must divide "
                       r"t_n_head \(8\) and t_d_inner \(2048\)"):
        AITDetector(workers.tiny_cfg(tp_size=3))
    with pytest.raises(ValueError, match="'model' axis of 2 ranks"):
        AITDetector(workers.tiny_cfg(tp_size=2))
