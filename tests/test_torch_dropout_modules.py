"""The port's dropout at module level against the JAX package's, float32 on
the CPU, one numpy-seeded param tree through the weight bridge, and the
same keep-masks injected on both sides (JAX's `jax.random.bernoulli`
replaced by a stand-in that hands them out in call order; the port's
`Dropout` given the same list).

* The plain-path `MultiHeadAttention`: more than 128 tokens on one side,
  so JAX takes its unfused branch too, with flax `nn.Dropout` on the f32
  probabilities and after fc (attention.py:313-316, :171-172).  This is the
  co-attention's path at the flagship's ~1900 image tokens, which the tiny
  flagship's whole-step test does not reach (its 48 image tokens fuse on
  both sides).  Output, input gradients and every parameter gradient.
* `MHACoAttention` draws both attentions' masks (coattention.py:56-65).
* The `Dropout` draws: the seeds from the caller's generator, the injected
  masks in order with their shapes checked.

Tolerances: outputs within 1e-5 relative of their scale; gradients within
1e-4 of each leaf's max |JAX value| (f32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_harness as harness
from ait_tpu.models import attention as jatt
from ait_tpu.models.coattention import MHACoAttention as JCoAtt
from ait_tpu_torch import bridge
from ait_tpu_torch.models import attention as patt
from ait_tpu_torch.models.coattention import MHACoAttention
from ait_tpu_torch.models.dropout import Dropout
from test_torch_port_modules import bridged, close, rand

KEEP = 0.9
T = torch.from_numpy


def _jax_with_masks(fn, masks):
    """fn() under the stand-in that hands out `masks`, or records the
    shapes asked for when masks is None; returns (result, feed)."""
    feed = harness.BernoulliFeed(masks)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", feed)
        return fn(), feed


@pytest.mark.parametrize("lq,lk", [(136, 24), (24, 136)])
def test_plain_path_attention_dropout_matches_flax(lq, lk):
    b = 2
    q = rand(30, b, lq, 512)
    kv = rand(31, b, lk, 512)
    g = rand(32, b, lq, 512)
    jmod = jatt.MultiHeadAttention(8, 512, 64, 64, 1 - KEEP,
                                   dtype=jnp.float32)
    pmod = patt.MultiHeadAttention(8, 512, 64, 64)
    params = bridged(jmod, pmod, jnp.asarray(q), jnp.asarray(kv),
                     jnp.asarray(kv), None)
    rngs = {"dropout": jax.random.PRNGKey(3)}

    def jf(p, q_, kv_):
        out, _ = jmod.apply({"params": p}, q_, kv_, kv_, None,
                            deterministic=False, rngs=rngs)
        return out

    _, rec = _jax_with_masks(lambda: jax.eval_shape(
        jf, params, jnp.asarray(q), jnp.asarray(kv)), None)
    assert rec.shapes == [(b, 8, lq, lk), (b, lq, 512)]
    masks = harness.keep_masks(rec.shapes, KEEP, seed=33)
    (want, vjp), _ = _jax_with_masks(lambda: jax.vjp(
        jf, params, jnp.asarray(q), jnp.asarray(kv)), masks)
    dparams, dq, dkv = vjp(jnp.asarray(g))

    tq = T(q).requires_grad_()
    tkv = T(kv).requires_grad_()
    out = pmod(tq, tkv, tkv, None, drop=Dropout(1 - KEEP, masks=masks))
    close(out, want, rel=1e-5)
    out.backward(T(g))
    pg = bridge.grad_tree(pmod)
    for name, got, ref in (("dq", tq.grad, dq), ("dkv", tkv.grad, dkv)):
        close(got, ref, rel=1e-4)
    for path, ref in harness_leaves(dparams):
        got = pg
        for k in path:
            got = got[k]
        close(np.asarray(got), ref, rel=1e-4)
    # the masks matter: without them the output differs
    with torch.no_grad():
        plain = pmod(T(q), T(kv), T(kv), None)
    assert not torch.allclose(plain, out.detach(), atol=1e-3)


def harness_leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from harness_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_coattention_drops_out_in_both_attentions():
    """Both of the co-attention's attentions draw (probabilities, then fc's
    output, each), q2i first; the port's outputs match JAX's with the same
    masks."""
    img, qry = rand(34, 2, 6, 8, 1024), rand(35, 2, 8, 8, 1024)
    jmod = JCoAtt(1024, 8, 64, 64, 1 - KEEP, dtype=jnp.float32)
    pmod = MHACoAttention(1024, 8, 64, 64)
    params = bridged(jmod, pmod, jnp.asarray(img), jnp.asarray(qry))
    rngs = {"dropout": jax.random.PRNGKey(4)}

    def jf():
        return jmod.apply({"params": params}, jnp.asarray(img),
                          jnp.asarray(qry), deterministic=False, rngs=rngs)

    _, rec = _jax_with_masks(lambda: jax.eval_shape(jf), None)
    # 48 image and 64 query tokens: both attentions fused (masks in the
    # head-major flat layout), q2i (image rows) first
    assert rec.shapes == [(8, 2 * 48, 64), (2 * 48, 512), (8, 2 * 64, 48),
                          (2 * 64, 512)]
    masks = harness.keep_masks(rec.shapes, KEEP, seed=36)
    (wi, wq), _ = _jax_with_masks(jf, masks)
    drop = Dropout(1 - KEEP, masks=masks)
    with torch.no_grad():
        gi, gq = pmod(T(img), T(qry), drop)
        pi, _ = pmod(T(img), T(qry))
    close(gi, wi, rel=1e-5)
    close(gq, wq, rel=1e-5)
    assert not torch.allclose(pi, gi, atol=1e-3)


def test_dropout_seeds_come_from_the_generator():
    """Seeds: [2] int32 from the caller's generator, in draw order, the same
    for the same generator state; a rate of 0 is inactive."""
    a = Dropout(0.1, torch.Generator().manual_seed(5))
    b = Dropout(0.1, torch.Generator().manual_seed(5))
    s1, s2 = a.seed("cpu"), a.seed("cpu")
    assert s1.dtype == torch.int32 and s1.shape == (2,)
    assert not torch.equal(s1, s2)
    assert torch.equal(s1, b.seed("cpu")) and torch.equal(s2, b.seed("cpu"))
    assert a.take((2, 3)) is None
    assert not Dropout(0.0).active and Dropout(0.1).active
    with pytest.raises(ValueError):
        Dropout(1.0)


def test_injected_masks_are_taken_in_order_and_checked():
    m = [np.ones((2, 3), bool), np.zeros((4,), bool)]
    d = Dropout(0.1, masks=m)
    (first,) = d.take((2, 3))
    assert first.shape == (2, 3) and bool(first.all())
    with pytest.raises(ValueError, match="site draws"):
        d.take((5,))
    d2 = Dropout(0.1, masks=m[:1])
    d2.take((2, 3))
    with pytest.raises(ValueError, match="more dropout sites"):
        d2.take((4,))
