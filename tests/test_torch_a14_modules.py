"""The A14 modules of the port against ait_tpu's, float32 on the CPU, each
on the same numpy-seeded inputs and the same weights (a JAX-layout tree
from `bridge.random_tree`, carried to the port by the weight bridge; the
GroupNorm affines random, not flax's zeros, so the non-local branch adds
something):

* `ZeroInitGroupNorm`: within 1e-5 abs (f32 statistics in both); under
  bf16 input the output is f32 in both;
* `NonLocalCoAttention`, 'division' and 'softmax': within 1e-4 of max
  |JAX| (the relation's sums over 6 x 7 and 3 x 3 tokens, reassociated);
  under bf16 compute both outputs are f32 in both packages and agree within
  5e-2 of max |JAX|: the embeddings and convs round to bf16 (an ulp is
  0.4-0.8%), the two frameworks' convolutions round a few of them the
  other way, and the GroupNorm over the query's 18-element groups
  amplifies that (measured 0.6-2.7%);
* `roi_pool`: bit-equal (a max of the same f32 values over the same
  integer bins);
* `VGGBackbone` (full widths, a 32x48 image): within 1e-4 of max |JAX|;
  `VGGTop` with the two dropouts' masks injected (flax form at 0.5):
  within 1e-5 of max |JAX|, and its 4 frozen blocks' params get no
  gradient;
* `ContextualRelation` over {GRU, LSTM} x {uni, bi} x {1, 2 layers}: the
  gate within 1e-6 abs, and the gradients of a random projection of it
  (`jax.grad` against autograd) for the stage inputs and every param within
  1e-5 of their max |JAX|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_harness as harness
from ait_tpu.models.coattention import NonLocalCoAttention as JaxNonLocal
from ait_tpu.models.layers import ZeroInitGroupNorm as JaxGN
from ait_tpu.models.resnet import ContextualRelation as JaxContextual
from ait_tpu.models.vgg import VGGBackbone as JaxVGG
from ait_tpu.models.vgg import VGGTop as JaxVGGTop
from ait_tpu.ops.roi_pool import roi_pool as jroi_pool
from ait_tpu_torch import bridge
from ait_tpu_torch.models.coattention import NonLocalCoAttention
from ait_tpu_torch.models.dropout import Dropout
from ait_tpu_torch.models.layers import ZeroInitGroupNorm
from ait_tpu_torch.models.resnet import ContextualRelation
from ait_tpu_torch.models.vgg import VGGBackbone, VGGTop
from ait_tpu_torch.ops.roi_pool import roi_pool


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def T(a):
    return torch.from_numpy(np.array(a))


def _rn(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def _pair(jmod, port, *args, seed=0, **kw):
    """The JAX tree of `jmod` at these inputs from `seed`, loaded into
    `port` too."""
    params = bridge.random_tree(harness.jax_shapes(jmod, *args, **kw), seed)
    assert bridge.jax_shapes(port) == harness.jax_shapes(jmod, *args, **kw)
    port.load_state_dict(bridge.to_state_dict(port, params))
    return params


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rel * scale, \
        np.abs(got - want).max() / scale


def test_group_norm_matches_jax():
    x = _rn(2, 5, 6, 64, scale=3.0) + 1.5
    jm, pm = JaxGN(32), ZeroInitGroupNorm(64)
    params = _pair(jm, pm, jnp.asarray(x))
    want = jm.apply({"params": params}, jnp.asarray(x))
    got = pm(T(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    xb = jnp.asarray(x, jnp.bfloat16)
    assert jm.apply({"params": params}, xb).dtype == jnp.float32
    assert pm(T(x).to(torch.bfloat16)).dtype == torch.float32


@pytest.mark.parametrize("normalization", ["division", "softmax"])
def test_nonlocal_coattention_matches_jax(normalization):
    xi, xq = _rn(2, 6, 7, 64, seed=1), _rn(2, 3, 3, 64, seed=2)
    jm = JaxNonLocal(64, normalization, dtype=jnp.float32)
    pm = NonLocalCoAttention(64, normalization)
    params = _pair(jm, pm, jnp.asarray(xi), jnp.asarray(xq), seed=3)
    assert np.abs(params["theta_gn"]["GroupNorm_0"]["scale"]).min() > 0
    wi, wq = jm.apply({"params": params}, jnp.asarray(xi), jnp.asarray(xq))
    gi, gq = pm(T(xi), T(xq))
    _close(gi.detach().numpy(), wi, 1e-4)
    _close(gq.detach().numpy(), wq, 1e-4)
    # the branch adds something: the output is not the residual alone
    assert np.abs(np.asarray(wi) - xi).max() > 1e-2


@pytest.mark.parametrize("normalization", ["division", "softmax"])
def test_nonlocal_coattention_bf16_outputs_f32(normalization):
    xi, xq = _rn(2, 6, 7, 64, seed=4), _rn(2, 3, 3, 64, seed=5)
    jm = JaxNonLocal(64, normalization, dtype=jnp.bfloat16)
    pm = NonLocalCoAttention(64, normalization, dtype=torch.bfloat16)
    xib, xqb = (jnp.asarray(x, jnp.bfloat16) for x in (xi, xq))
    params = _pair(jm, pm, xib, xqb, seed=6)
    wi, wq = jm.apply({"params": params}, xib, xqb)
    gi, gq = pm(T(np.asarray(xib.astype(jnp.float32))).to(torch.bfloat16),
                T(np.asarray(xqb.astype(jnp.float32))).to(torch.bfloat16))
    assert wi.dtype == wq.dtype == jnp.float32
    assert gi.dtype == gq.dtype == torch.float32
    _close(gi.detach().numpy(), wi, 5e-2)
    _close(gq.detach().numpy(), wq, 5e-2)


def test_roi_pool_bit_equal_jax():
    rng = np.random.RandomState(7)
    feat = rng.randn(2, 10, 13, 8).astype(np.float32)
    xy = rng.uniform(-20, 200, (2, 12, 2))
    wh = rng.uniform(0, 120, (2, 12, 2))
    rois = np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)
    rois[0, 0] = [0, 0, 207, 159]                  # the whole map
    rois[0, 1] = [300, 300, 310, 310]              # off the map: zeros
    rois[1, 2] = [40, 40, 40, 40]                  # a point
    want = jroi_pool(jnp.asarray(feat), jnp.asarray(rois), out_size=7,
                     spatial_scale=1.0 / 16.0)
    got = roi_pool(T(feat), T(rois), out_size=7, spatial_scale=1.0 / 16.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[0, 1] == 0).all() and (got[0, 0] != 0).any()


def test_vgg_backbone_matches_jax():
    x = _rn(1, 32, 48, 3, seed=8)
    jm, pm = JaxVGG(dtype=jnp.float32), VGGBackbone()
    params = _pair(jm, pm, jnp.asarray(x), seed=9)
    want = jm.apply({"params": params}, jnp.asarray(x))
    got = pm(T(x))
    assert got.shape == (1, 2, 3, 512)
    _close(got.detach().numpy(), want, 1e-4)
    frozen = [n for n, p in pm.named_parameters() if not p.requires_grad]
    assert sorted(frozen) == sorted(
        f"conv{b}_{c}.{leaf}" for b in (1, 2) for c in (1, 2)
        for leaf in ("weight", "bias"))


def test_vgg_top_matches_jax_with_injected_masks(monkeypatch):
    x = np.maximum(_rn(3, 2, 2, 512, seed=10), 0)
    jm, pm = JaxVGGTop(dtype=jnp.float32), VGGTop(2 * 2 * 512)
    params = _pair(jm, pm, jnp.asarray(x), seed=11)
    masks = harness.keep_masks([(3, 4096), (3, 4096)], 0.5, seed=12)
    monkeypatch.setattr(jax.random, "bernoulli", harness.BernoulliFeed(masks))
    want = jm.apply({"params": params}, jnp.asarray(x), deterministic=False,
                    rngs={"dropout": jax.random.PRNGKey(0)})
    # the top's rate is its own 0.5, whatever t_dropout is
    got = pm(T(x), Dropout(0.0, masks=masks))
    _close(got.detach().numpy(), want, 1e-5)
    evals = jm.apply({"params": params}, jnp.asarray(x))
    _close(pm(T(x)).detach().numpy(), evals, 1e-5)


RNN_CASES = [(m, bi, layers) for m in ("GRU", "LSTM") for bi in (False, True)
             for layers in (1, 2)]


@pytest.mark.parametrize("method,bidirectional,layers", RNN_CASES)
def test_contextual_relation_matches_jax(method, bidirectional, layers):
    stages = [_rn(2, s, s, c, seed=20 + i)
              for i, (s, c) in enumerate(((4, 256), (2, 512), (1, 1024)))]
    kw = dict(channels=64, reduction=8, rnn_layers=layers,
              bidirectional=bidirectional, method=method)
    jm = JaxContextual(**kw)
    pm = ContextualRelation(**kw)
    jst = [jnp.asarray(s) for s in stages]
    params = _pair(jm, pm, jst, seed=30 + layers)
    cot = _rn(2, 64, seed=40)

    def jloss(p, st):
        return jnp.sum(jm.apply({"params": p}, st) * cot)

    want = jm.apply({"params": params}, jst)
    jgp, jgs = jax.grad(jloss, argnums=(0, 1))(params, jst)
    pst = [T(s).requires_grad_(True) for s in stages]
    got = pm(pst)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)
    (got * T(cot)).sum().backward()
    for g, w in zip(pst, jgs):
        _close(g.grad.numpy(), w, 1e-5)
    pgrad = bridge.grad_tree(pm)
    for path, w in harness_leaves(jgp):
        g = pgrad
        for k in path:
            g = g[k]
        _close(g, w, 1e-5)


def harness_leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from harness_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)
