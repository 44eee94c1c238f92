"""Sequence parallelism of the port (ait_tpu_torch/parallel/sp.py and the
sp branches of the co-attentions) on gloo process groups of the CPU.

* `seq_parallel_attention` over 2 ranks against the JAX package's on its
  virtual 8-device mesh and the unsharded softmax attention, unmasked and
  with a key mask (tests/test_sp.py:25-80): forward within 1e-5, dq and
  each rank's block of dk and dv within 2e-5 of JAX's unsharded gradients
  (torch autograd needs no scale of the k/v cotangents, where the JAX
  package's shard_map does);
* both co-attentions with their image tokens over 2 ranks (63 tokens: the
  last block padded) against the JAX package's unsharded modules on the
  same weights, within 2e-5 (tests/test_sp.py:115-166);
* port against port, the tiny flagship's eval on a (data 1 x seq 2) mesh
  against unsharded eval, for both co-attentions: the roi sets agree, and
  the head outputs on the rois the two share within 1e-3 (tests/
  test_sp.py:231); training under sp is refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import torch_parallel_workers as workers
import torch_port_harness as harness
from ait_tpu.models.coattention import MHACoAttention as JaxMHA
from ait_tpu.models.coattention import NonLocalCoAttention as JaxNonLocal
from ait_tpu.parallel import make_mesh
from ait_tpu.parallel.sharded import shard_map
from ait_tpu.parallel.sp import seq_parallel_attention as jax_sp
from ait_tpu_torch import bridge
from ait_tpu_torch.models.coattention import (MHACoAttention,
                                              NonLocalCoAttention)

S = 2


def full_attention(q, k, v, scale, mask=None):
    s = jnp.einsum("...qd,...kd->...qk", q, k) * scale
    if mask is not None:
        s = jnp.where(mask, s, -jnp.inf)
    return jnp.einsum("...qk,...kv->...qv", jax.nn.softmax(s, axis=-1), v)


@pytest.mark.parametrize("masked", [False, True])
def test_seq_parallel_attention_matches_jax(masked):
    rng = np.random.RandomState(0)
    h, tq, tk, dk, dv = 2, 8, 32, 16, 16
    scale = 1.0 / dk ** 0.5
    q = rng.randn(h, tq, dk).astype(np.float32)
    k = rng.randn(h, tk, dk).astype(np.float32)
    v = rng.randn(h, tk, dv).astype(np.float32)
    mask = None
    if masked:
        mask = rng.rand(h, tq, tk) < 0.7
        mask[..., 0] = True

    mesh = make_mesh(4, axes=("seq",))
    if masked:
        sp = shard_map(lambda a, b, c, m: jax_sp(a, b, c, "seq", scale, m),
                       mesh, in_specs=(P(), P(None, "seq"), P(None, "seq"),
                                       P(None, None, "seq")),
                       out_specs=P())
        jax_out = jax.jit(sp)(q, k, v, mask)
    else:
        sp = shard_map(lambda a, b, c: jax_sp(a, b, c, "seq", scale), mesh,
                       in_specs=(P(), P(None, "seq"), P(None, "seq")),
                       out_specs=P())
        jax_out = jax.jit(sp)(q, k, v)
    want = full_attention(q, k, v, scale, mask)
    g_want = jax.grad(lambda a, b, c: (full_attention(
        a, b, c, scale, mask) ** 2).sum(), argnums=(0, 1, 2))(q, k, v)

    ranks = workers.run(workers.sp_attention, S, q, k, v, mask, scale)
    dk = np.concatenate([r[2] for r in ranks], axis=1)
    dv = np.concatenate([r[3] for r in ranks], axis=1)
    for out, dq, _, _ in ranks:
        np.testing.assert_allclose(out, np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(out, np.asarray(jax_out), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(dq, np.asarray(g_want[0]), rtol=2e-5,
                                   atol=2e-6)
    np.testing.assert_allclose(dk, np.asarray(g_want[1]), rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_allclose(dv, np.asarray(g_want[2]), rtol=2e-5,
                               atol=2e-6)


CASES = [("mha", None), ("nonlocal", "division"), ("nonlocal", "softmax")]


@pytest.fixture(scope="module")
def coattention():
    """JAX's unsharded modules and the port's over S ranks, one spawn for
    the three cases."""
    rng = np.random.RandomState(2)
    b, hi, wi, hq, wq, c = 2, 7, 9, 4, 4, 64
    x_img = (rng.randn(b, hi, wi, c) * 0.5).astype(np.float32)
    x_qry = (rng.randn(b, hq, wq, c) * 0.5).astype(np.float32)
    states, want = {}, {}
    for kind, norm in CASES:
        if kind == "mha":
            jmod = JaxMHA(c, n_head=4, d_k=8, d_v=8, dropout=0.0)
            port = MHACoAttention(c, n_head=4, d_k=8, d_v=8)
        else:
            jmod = JaxNonLocal(c, norm)
            port = NonLocalCoAttention(c, norm)
        shapes = harness.jax_shapes(jmod, x_img, x_qry)
        assert bridge.jax_shapes(port) == shapes
        params = bridge.random_tree(shapes, 3)
        states[kind, norm] = {
            k: v.numpy()
            for k, v in bridge.to_state_dict(port, params).items()}
        want[kind, norm] = jmod.apply({"params": params}, x_img, x_qry)
    ranks = workers.run(workers.sp_coattention, S, states, x_img, x_qry)
    return want, ranks


@pytest.mark.parametrize("kind,norm", CASES)
def test_coattention_under_sp_matches_jax(coattention, kind, norm):
    want, ranks = coattention
    for got in ranks:
        got_img, got_qry = got[kind, norm]
        np.testing.assert_allclose(got_img, np.asarray(want[kind, norm][0]),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got_qry, np.asarray(want[kind, norm][1]),
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("coattention", ["mha", "nonlocal"])
def test_detector_eval_on_data_seq_mesh(coattention):
    got, want, train_error = workers.run(workers.sp_detector, 2,
                                         coattention)[0]
    assert "inference-path feature" in train_error
    r_g, r_w = got["rois"], want["rois"]
    d = np.abs(r_g[:, :, None, :] - r_w[:, None, :, :]).max(-1)
    assert min((d.min(axis=2) < 0.1).mean(), (d.min(axis=1) < 0.1).mean()) \
        >= 0.95
    same = np.abs(r_g - r_w).max(-1) < 0.1
    assert same.mean() >= 0.7
    for k in ("cls_prob", "bbox_pred"):
        np.testing.assert_allclose(got[k][same], want[k][same], rtol=1e-3,
                                   atol=1e-3, err_msg=k)
