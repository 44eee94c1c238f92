"""The port's GPipe pipeline (ait_tpu_torch/parallel/pp.py) on gloo process
groups of the CPU, against the JAX package's make_pipeline_apply on its
virtual 8-device mesh (tests/test_pp.py's stage and sizes), forward within
2e-6 and every stage gradient within 1e-4 (f32, other summation orders);
and with the AIT encoder layer as the stage, against the layers run one
after the other in this process (a stream that S does not divide, so the
padding is exercised)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from ait_tpu.parallel import make_mesh
from ait_tpu.parallel.pp import (make_pipeline_apply, shard_stage_params,
                                 stack_stage_params)
from ait_tpu_torch import bridge
from ait_tpu_torch.models.ait_transformer import EncoderLayer


def jax_stage(p, x):
    h = jnp.tanh(x @ p["w1"] + p["b1"])
    return x + h @ p["w2"]


@pytest.mark.parametrize("n_stages,m", [(2, 4), (4, 8)])
def test_pipeline_matches_jax_fwd_and_grad(n_stages, m):
    rng = np.random.RandomState(0)
    d, hidden, b = 16, 32, 4
    per_stage = [{"w1": (rng.randn(d, hidden) * 0.3).astype(np.float32),
                  "b1": (rng.randn(hidden) * 0.1).astype(np.float32),
                  "w2": (rng.randn(hidden, d) * 0.3).astype(np.float32)}
                 for _ in range(n_stages)]
    x = rng.randn(m, b, d).astype(np.float32)
    stacked = {k: np.stack([p[k] for p in per_stage]) for k in per_stage[0]}

    mesh = make_mesh(n_stages, axes=("stage",))
    jstacked = stack_stage_params(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in per_stage])
    piped = jax.jit(make_pipeline_apply(jax_stage, mesh, m))
    params = shard_stage_params(jstacked, mesh)
    want = piped(params, jnp.asarray(x))
    g_want = jax.jit(jax.grad(
        lambda p, a: (piped(p, a) ** 2).sum()))(params, jnp.asarray(x))

    results = workers.run(workers.pipeline, n_stages, stacked, x, m)
    got, grads = results[0]
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-6, atol=2e-6)
    for s in range(n_stages):
        for k in stacked:
            np.testing.assert_allclose(
                grads[s][k], np.asarray(g_want[k])[s], rtol=1e-4, atol=1e-4,
                err_msg=f"stage {s} {k}")


def test_encoder_layer_pipeline_matches_sequential():
    """Three encoder layers over 3 ranks, 4 microbatches (padded to 6)."""
    s, m = 3, 4
    layers = [EncoderLayer(32, 64, 4, 8, 8) for _ in range(s)]
    states = []
    for i, layer in enumerate(layers):
        layer.load_state_dict(bridge.to_state_dict(
            layer, bridge.random_tree(bridge.jax_shapes(layer), i)))
        states.append({k: v.numpy() for k, v in layer.state_dict().items()})
    x = np.random.RandomState(1).randn(m, 2, 8, 32).astype(np.float32)

    a = torch.from_numpy(x)
    for layer in layers:
        a = torch.stack([layer(a[i], None) for i in range(m)])
    (a ** 2).sum().backward()

    results = workers.run(workers.encoder_pipeline, s, states, x, m)
    np.testing.assert_allclose(results[0][0], a.detach().numpy(), rtol=2e-5,
                               atol=2e-5)
    for layer, (_, grads) in zip(layers, results):
        for k, p in layer.named_parameters():
            scale = max(float(p.grad.abs().max()), 1e-6)
            assert np.abs(grads[k] - p.grad.numpy()).max() <= 1e-4 * scale, k
