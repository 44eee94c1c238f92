"""Each module of the port against its flax counterpart, from one
numpy-seeded param tree carried across by the weight bridge; float32 on the
CPU, full widths, small spatial sizes.

Tolerance: the two frameworks sum in another order (and the JAX stem runs
its 7x7/2 conv as the exact space-to-depth rewrite), so float32 results
agree to ~1e-6 relative per layer; 1e-4 of the output's scale leaves room
for the depth of ResNet-50.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_harness as harness
from ait_tpu.models import attention as jatt
from ait_tpu.models import layers as jlayers
from ait_tpu.models.ait_transformer import AITTransformer as JTransformer
from ait_tpu.models.coattention import MHACoAttention as JCoAtt
from ait_tpu.models.resnet import ResNetBackbone as JBackbone
from ait_tpu.models.resnet import ResNetTop as JTop
from ait_tpu.models.rpn import RPNHead as JRPN
from ait_tpu.models.rpn import proposal_layer as jproposal_layer
from ait_tpu.models.sknet import SKNet as JSKNet
from ait_tpu.ops.anchors import shifted_anchors
from ait_tpu_torch import bridge
from ait_tpu_torch.models import attention as patt
from ait_tpu_torch.models import layers as players
from ait_tpu_torch.models.ait_transformer import AITTransformer
from ait_tpu_torch.models.coattention import MHACoAttention
from ait_tpu_torch.models.resnet import ResNetBackbone, ResNetTop
from ait_tpu_torch.models.rpn import RPNHead, RPNOut, proposal_layer
from ait_tpu_torch.models.sknet import SKNet

T = torch.from_numpy


def bridged(jmod, pmod, *args, seed=0, **kw):
    """Params for the flax module; the port module loaded with them."""
    params = bridge.random_tree(harness.jax_shapes(jmod, *args, **kw), seed)
    pmod.load_state_dict(bridge.to_state_dict(pmod, params))
    pmod.eval()
    return params


def close(got, want, rel=1e-4):
    got, want = harness.to_np(got), np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale)


def rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def test_sinusoid_table_exact():
    np.testing.assert_array_equal(players.sinusoid_table(64, 512),
                                  np.asarray(jlayers.sinusoid_table(64, 512)))


@pytest.mark.parametrize("h,w", [(8, 8), (15, 20), (304, 400)])
def test_max_pool_ceil_exact(h, w):
    x = rand(0, 2, h, w, 4)
    want = np.asarray(jlayers.max_pool_ceil(jnp.asarray(x), 3, 2))
    got = players.to_nhwc(players.max_pool_ceil(players.to_nchw(T(x)), 3, 2))
    np.testing.assert_array_equal(got.numpy(), want)


def test_frozen_batchnorm():
    x = rand(1, 2, 5, 6, 16)
    jmod = jlayers.FrozenBatchNorm(16)
    pmod = players.FrozenBatchNorm(16)
    params = bridged(jmod, pmod, jnp.asarray(x), seed=1)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    got = players.to_nhwc(pmod(players.to_nchw(T(x))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_resnet_backbone():
    x = rand(2, 1, 64, 96, 3)
    jmod = JBackbone("resnet50", dtype=jnp.float32)
    pmod = ResNetBackbone("resnet50")
    params = bridged(jmod, pmod, jnp.asarray(x))
    want = jax.jit(jmod.apply)({"params": params}, jnp.asarray(x))
    with torch.inference_mode():
        close(pmod(T(x)), want)


def test_resnet_top():
    x = rand(3, 3, 8, 8, 1024)
    jmod = JTop("resnet50", dtype=jnp.float32)
    pmod = ResNetTop("resnet50")
    params = bridged(jmod, pmod, jnp.asarray(x))
    want = jax.jit(jmod.apply)({"params": params}, jnp.asarray(x))
    with torch.inference_mode():
        close(pmod(T(x)), want)


@pytest.mark.parametrize("lq,lk,mask_kind", [
    (56, 56, "pad"),        # encoder self-attention: the fused path
    (64, 64, "causal"),     # decoder self-attention: fused
    (64, 56, "pad"),        # decoder cross-attention: fused
    (100, 64, None),        # JAX fuses (<= 128), the port's plain path
    (150, 64, None),        # both plain (co-attention's class)
])
def test_multi_head_attention(lq, lk, mask_kind):
    q = rand(4, 2, lq, 512)
    kv = q if lq == lk else rand(5, 2, lk, 512)
    if mask_kind == "pad":
        mask = np.arange(lk)[None, None, :] < 49
    elif mask_kind == "causal":
        mask = np.tril(np.ones((lq, lk), bool))[None]
    else:
        mask = None
    jmod = jatt.MultiHeadAttention(8, 512, 64, 64, 0.1, dtype=jnp.float32)
    pmod = patt.MultiHeadAttention(8, 512, 64, 64)
    jq = jnp.asarray(q)
    jkv = jq if lq == lk else jnp.asarray(kv)
    jmask = None if mask is None else jnp.asarray(mask)
    params = bridged(jmod, pmod, jq, jkv, jkv, jmask)
    want, _ = jmod.apply({"params": params}, jq, jkv, jkv, jmask)
    tq = T(q)
    tkv = tq if lq == lk else T(kv)
    with torch.inference_mode():
        got = pmod(tq, tkv, tkv, None if mask is None else T(mask))
    close(got, want, rel=1e-5)


def test_positionwise_feed_forward():
    x = rand(6, 3, 56, 512)
    jmod = jatt.PositionwiseFeedForward(512, 2048, 0.1, jnp.float32)
    pmod = patt.PositionwiseFeedForward(512, 2048)
    params = bridged(jmod, pmod, jnp.asarray(x))
    want = jmod.apply({"params": params}, jnp.asarray(x))
    with torch.inference_mode():
        close(pmod(T(x)), want, rel=1e-5)


def test_mha_coattention():
    img, qry = rand(7, 2, 6, 8, 1024), rand(8, 2, 8, 8, 1024)
    jmod = JCoAtt(1024, 8, 64, 64, 0.1, dtype=jnp.float32)
    pmod = MHACoAttention(1024, 8, 64, 64)
    params = bridged(jmod, pmod, jnp.asarray(img), jnp.asarray(qry))
    wi, wq = jmod.apply({"params": params}, jnp.asarray(img),
                        jnp.asarray(qry))
    with torch.inference_mode():
        gi, gq = pmod(T(img), T(qry))
    close(gi, wi, rel=1e-5)
    close(gq, wq, rel=1e-5)


def test_rpn_head_and_proposal_layer():
    feat = rand(9, 2, 6, 8, 1024)
    jmod = JRPN(num_anchors=9, dtype=jnp.float32)
    pmod = RPNHead(1024, 9)
    params = bridged(jmod, pmod, jnp.asarray(feat))
    jout = jmod.apply({"params": params}, jnp.asarray(feat))
    with torch.inference_mode():
        pout = pmod(T(feat))
    close(pout.cls_logits, jout.cls_logits, rel=1e-5)
    close(pout.bbox_deltas, jout.bbox_deltas, rel=1e-5)

    # the proposal layer on the SAME head outputs (JAX's)
    anchors = shifted_anchors(6, 8, 16)
    info = np.asarray([[90, 120, 1.0], [70, 128, 1.0]], np.float32)
    want = jproposal_layer(jout, anchors, jnp.asarray(info), pre_nms_topk=64,
                           post_nms_topk=16, nms_thresh=0.7,
                           use_pallas_nms=False)
    got = proposal_layer(
        RPNOut(T(np.array(jout.cls_logits)), T(np.array(jout.bbox_deltas))),
        T(np.array(anchors)), T(info), pre_nms_topk=64, post_nms_topk=16,
        nms_thresh=0.7)
    # decode uses exp, whose last ulp differs between XLA and PyTorch
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-3)


def test_ait_transformer():
    props, query = rand(10, 2 * 5, 7, 7, 1024), rand(11, 2, 8, 8, 1024)
    jmod = JTransformer(channels=1024, dtype=jnp.float32)
    pmod = AITTransformer(channels=1024)
    params = bridged(jmod, pmod, jnp.asarray(props), jnp.asarray(query))
    want = jax.jit(jmod.apply)({"params": params}, jnp.asarray(props),
                               jnp.asarray(query))
    with torch.inference_mode():
        close(pmod(T(props), T(query)), want, rel=1e-5)


def test_sknet():
    props, query = rand(12, 4, 8, 8, 1024), rand(13, 2, 8, 8, 1024)
    jmod = JSKNet(1024, dtype=jnp.float32)
    pmod = SKNet(1024)
    params = bridged(jmod, pmod, jnp.asarray(props), jnp.asarray(query))
    wp, wq = jax.jit(jmod.apply)({"params": params}, jnp.asarray(props),
                                 jnp.asarray(query))
    with torch.inference_mode():
        gp, gq = pmod(T(props), T(query))
    close(gp, wp)
    close(gq, wq)
