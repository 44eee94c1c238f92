"""The eval-time FrozenBN fold of the port (models/resnet.py::fold_frozen_bn,
models/layers.py::BN_BIAS_ONLY) against ait_tpu's, float32 on the CPU.

The BN statistics are nontrivial (`_randomize_bn`, as tests/test_bn_fold.py
draws them: under init's identity statistics the fold is a no-op):

* the port's folded state_dict, through the weight bridge, against
  `ait_tpu.models.resnet.fold_frozen_bn` on the same tree: every leaf
  within rtol = atol = 2e-4 (tests/test_bn_fold.py's bound; the products
  are the same f32 operations, the rsqrt may differ in the last ulp);
* after the fold every FrozenBatchNorm's w = scale * rsqrt(var + eps) is 1
  bit for bit, and its bias is b - m * w;
* folded against unfolded, ResNet-50 backbone and top: within
  rtol = atol = 2e-4, with and without BN_BIAS_ONLY; the bias-only program
  on unfolded weights diverges;
* the tiny flagship's eval forward, folded with BN_BIAS_ONLY, against the
  unfolded forward: cls_prob within 1e-4, rois within 5e-2 px (the fold
  moves the features by f32 roundoff, ~1e-5 relative, and box decoding
  scales the RPN's deltas by anchors up to 512 px: measured 1.5e-2 px).
"""

import numpy as np
import pytest
import torch

import torch_port_harness as harness
from ait_tpu.models.resnet import fold_frozen_bn as jfold
from ait_tpu_torch import bridge
from ait_tpu_torch.models import layers
from ait_tpu_torch.models.layers import FrozenBatchNorm
from ait_tpu_torch.models.resnet import (ResNetBackbone, ResNetTop,
                                         fold_frozen_bn)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _randomize_bn(state, seed):
    """Nontrivial FrozenBN statistics in a port state_dict (the ranges of
    tests/test_bn_fold.py::_randomize_bn)."""
    rng = np.random.RandomState(seed)
    out = dict(state)
    for k, v in state.items():
        leaf = k.rsplit(".", 1)[-1]
        if ".bn" not in "." + k and "downsample_bn" not in k:
            continue
        shape = tuple(v.shape)
        val = {"scale": 0.5 + rng.rand(*shape),
               "bias": rng.randn(*shape) * 0.3,
               "mean": rng.randn(*shape) * 0.2,
               "var": 0.3 + rng.rand(*shape)}[leaf]
        out[k] = torch.from_numpy(val.astype(np.float32))
    return out


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def test_fold_matches_ait_tpu():
    _, _, _, _, pmodel = harness.flagship()
    state = _randomize_bn(pmodel.state_dict(), 0)
    params = bridge.to_jax_tree(pmodel, state)
    want = jfold(params)
    got = bridge.to_jax_tree(pmodel, fold_frozen_bn(state))
    n_changed = 0
    for path, w in _leaves(want):
        g = _get(got, path)
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4,
                                   err_msg="/".join(path))
        n_changed += not np.array_equal(w, _get(params, path))
    # every paired conv kernel and BN leaf moved: 53 pairs x 5 leaves,
    # less the BN scales and means that happen to stay
    assert n_changed > 200


def test_folded_bn_is_identity_scale_bitwise():
    m = ResNetBackbone()
    folded = fold_frozen_bn(_randomize_bn(m.state_dict(), 1))
    m.load_state_dict(folded)
    bns = [mod for mod in m.modules() if isinstance(mod, FrozenBatchNorm)]
    assert len(bns) == 1 + 3 * 3 + 4 * 3 + 6 * 3 + 3   # stem + blocks + ds
    for bn in bns:
        w = bn.scale * torch.rsqrt(bn.var + bn.eps)
        assert torch.equal(w, torch.ones_like(w))
        assert torch.equal(bn.mean, torch.zeros_like(bn.mean))


@pytest.mark.parametrize("bias_only", [False, True])
def test_folded_backbone_and_top_match_unfolded(monkeypatch, bias_only):
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(1, 64, 80, 3).astype("f") * 0.5)
    f = torch.from_numpy(rng.randn(2, 7, 7, 1024).astype("f") * 0.2)
    for mod, inp, seed in ((ResNetBackbone(), x, 3), (ResNetTop(), f, 4)):
        tree = bridge.random_tree(bridge.jax_shapes(mod), seed)
        state = _randomize_bn(bridge.to_state_dict(mod, tree), seed)
        mod.load_state_dict(state)
        with torch.no_grad():
            want = mod(inp)
            mod.load_state_dict(fold_frozen_bn(state))
            monkeypatch.setattr(layers, "BN_BIAS_ONLY", bias_only)
            got = mod(inp)
            monkeypatch.setattr(layers, "BN_BIAS_ONLY", False)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                                   atol=2e-4)
        if bias_only:                  # never on unfolded weights
            mod.load_state_dict(state)
            monkeypatch.setattr(layers, "BN_BIAS_ONLY", True)
            with torch.no_grad():
                wrong = mod(inp)
            monkeypatch.setattr(layers, "BN_BIAS_ONLY", False)
            assert np.abs(wrong.numpy() - want.numpy()).max() > \
                1e-2 * np.abs(want.numpy()).max()


def test_folded_flagship_eval_forward(monkeypatch):
    _, _, _, pcfg, pmodel = harness.flagship()
    state = _randomize_bn(pmodel.state_dict(), 5)
    image, query, info = (torch.from_numpy(a) for a in harness.batch(2))
    model = type(pmodel)(pcfg, dtype=torch.float32).eval()
    with torch.inference_mode():
        model.load_state_dict(state)
        want = model(image, query, info)
        model.load_state_dict(fold_frozen_bn(state))
        monkeypatch.setattr(layers, "BN_BIAS_ONLY", True)
        got = model(image, query, info)
    np.testing.assert_allclose(got.rois.numpy(), want.rois.numpy(), rtol=0,
                               atol=5e-2)
    np.testing.assert_allclose(got.cls_prob.numpy(), want.cls_prob.numpy(),
                               rtol=0, atol=1e-4)
