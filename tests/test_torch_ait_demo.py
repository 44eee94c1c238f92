"""The AIT demo (ait_tpu_torch/tools/ait_demo.py, counterpart of
tools/ait_demo.py) on the CPU: its shape contract, [256, 7, 7, 1024]
proposals x [2, 8, 8, 1024] query -> [256, 8, 8, 1024] finite features,
printed with `ok`; and the module it builds, with `init_module`'s weights,
against ait_tpu's AITTransformer on those weights."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_port_harness as harness
from ait_tpu.models.ait_transformer import AITTransformer as JaxAIT
from ait_tpu_torch import bridge
from ait_tpu_torch.models.ait_transformer import AITTransformer
from ait_tpu_torch.tools import ait_demo
from ait_tpu_torch.train import init_module


def test_demo_shape_contract(capsys):
    out = ait_demo.main(["--device", "cpu"])
    assert tuple(out.shape) == (256, 8, 8, 1024)
    assert torch.isfinite(out).all()
    printed = capsys.readouterr().out.splitlines()
    assert printed[0] == "x_props  (256, 7, 7, 1024)"
    assert printed[1] == "x_query  (2, 8, 8, 1024)"
    assert printed[2].startswith("output   (256, 8, 8, 1024)")
    assert printed[-1] == "ok"


def test_demo_module_matches_jax():
    rng = np.random.RandomState(0)
    props = rng.randn(2 * 4, 7, 7, 1024).astype(np.float32)
    query = rng.randn(2, 8, 8, 1024).astype(np.float32)
    pm = init_module(AITTransformer(n_layers=1, channels=1024), 0).eval()
    jm = JaxAIT(n_layers=1, channels=1024)
    shapes = harness.jax_shapes(jm, jnp.asarray(props[:2]),
                                jnp.asarray(query[:1]), deterministic=True)
    assert bridge.jax_shapes(pm) == shapes
    params = bridge.to_jax_tree(pm, pm.state_dict())
    want = np.asarray(jax.jit(lambda p, a, q: jm.apply(
        {"params": p}, a, q, deterministic=True))(
            params, jnp.asarray(props), jnp.asarray(query)))
    with torch.inference_mode():
        got = pm(torch.from_numpy(props), torch.from_numpy(query)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
