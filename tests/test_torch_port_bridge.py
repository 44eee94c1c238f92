"""The weight bridge: every leaf of the flagship's JAX param tree maps onto
the port's state_dict with its shape checked, none is left over on either
side, and a layout error is refused."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_harness as harness
from ait_tpu.models.sknet import SKBlock as JSKBlock
from ait_tpu_torch import bridge
from ait_tpu_torch.models import AITDetector
from ait_tpu_torch.models.sknet import SKBlock


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.fixture(scope="module")
def flagship():
    return harness.flagship()


def test_port_layout_equals_jax_tree(flagship):
    """bridge.jax_shapes (from the port module alone) is exactly the JAX
    tree: same leaves, same shapes."""
    _, _, params, pcfg, _ = flagship
    want = {p: tuple(np.shape(v)) for p, v in _flat(params)}
    got = dict(_flat(bridge.jax_shapes(AITDetector(pcfg))))
    assert got == want
    assert len(want) == 355


def test_every_leaf_maps_with_layout(flagship):
    _, _, params, _, pmodel = flagship
    sd = bridge.to_state_dict(pmodel, params)
    assert set(sd) == set(pmodel.state_dict())
    assert sum(v.numel() for v in sd.values()) == sum(
        np.size(v) for _, v in _flat(params))
    # one leaf of each layout rule
    conv = params["sk"]["sk_props"]["conv1"]["kernel"]      # grouped [3,3,128,1024]
    np.testing.assert_array_equal(sd["sk.sk_props.conv1.weight"].numpy(),
                                  np.transpose(conv, (3, 2, 0, 1)))
    dense = params["cls_score_0"]["kernel"]                 # [4096, 8]
    np.testing.assert_array_equal(sd["cls_score_0.weight"].numpy(), dense.T)
    raw = params["transformer"]["enc_layer0"]["slf_attn"]["w_qs"]["kernel"]
    np.testing.assert_array_equal(
        sd["transformer.enc_layer0.slf_attn.w_qs.kernel"].numpy(), raw)
    bn = params["backbone"]["layer1"]["block0"]["bn1"]["var"]
    np.testing.assert_array_equal(
        sd["backbone.layer1.block0.bn1.var"].numpy(), bn)


def _copy(tree):
    return {k: _copy(v) if isinstance(v, dict) else v
            for k, v in tree.items()}


@pytest.mark.parametrize("fault", ["extra", "missing", "shape"])
def test_bridge_refuses_mismatch(flagship, fault):
    _, _, params, _, pmodel = flagship
    bad = _copy(params)
    if fault == "extra":
        bad["rpn"]["conv"]["scale"] = np.ones(512, np.float32)
        match = "left over"
    elif fault == "missing":
        del bad["top"]["layer4"]["block2"]["bn3"]["mean"]
        match = "missing"
    else:
        k = bad["coattention"]["img_trans"]["kernel"]
        bad["coattention"]["img_trans"]["kernel"] = k.T       # torch layout
        match = "shape"
    with pytest.raises(ValueError, match=match):
        bridge.to_state_dict(pmodel, bad)


def test_grouped_conv_layout_computes_the_same():
    """SKNet's grouped convs ([k, k, C/8, C] -> [C, C/8, k, k]) through the
    bridge give flax's result."""
    x = np.random.RandomState(0).randn(2, 5, 6, 64).astype(np.float32)
    jmod = JSKBlock(64, dtype=jnp.float32)
    params = bridge.random_tree(harness.jax_shapes(jmod, jnp.asarray(x)), 3)
    pmod = SKBlock(64)
    pmod.load_state_dict(bridge.to_state_dict(pmod, params))
    want = jmod.apply({"params": params}, jnp.asarray(x))
    with torch.inference_mode():
        got = pmod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_random_tree_is_seeded():
    shapes = {"a": {"kernel": (3, 4), "bias": (4,)},
              "bn": {"scale": (2,), "bias": (2,), "mean": (2,), "var": (2,)}}
    t1, t2 = bridge.random_tree(shapes, 7), bridge.random_tree(shapes, 7)
    t3 = bridge.random_tree(shapes, 8)
    for (p, a), (_, b), (_, c) in zip(_flat(t1), _flat(t2), _flat(t3)):
        assert a.dtype == np.float32 and a.shape == shapes[p[0]][p[1]]
        np.testing.assert_array_equal(a, b)
        assert not np.array_equal(a, c)
    assert (t1["bn"]["var"] > 0).all()
