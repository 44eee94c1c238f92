"""The dropout forms of the port's fused Functions and their plain versions
on the CPU, against the JAX package's references and its Pallas kernels run
in interpret mode.

* With real 0/1 masks, the plain versions (`sh_attention_reference`,
  `ffn_reference`, `posln_reference`) against `_reference_impl`,
  `ffn_reference` and `posln_reference` of ait_tpu, forward and VJP, and the
  port's `fused_sh_attention_dropout` against the Pallas kernel of the same
  name (operand masks), forward and VJP.
* The in-kernel-PRNG forms (`fused_sh_attention_rngdrop`, `fused_ffn` and
  `fused_posln` with a seed at keep_prob 0.9): in interpret mode the TPU
  interpreter stubs the random bits to zeros, so every mask keeps
  everything (tests/test_rng_dropout.py); they are held against the port's
  plain versions fed all-ones masks at keep_prob 0.9.
* The port's seeded Functions against its plain versions fed the Philox
  stream's masks for the same seed (the same arithmetic, so exact).

Narrow widths keep the interpret runs short.  float32 on both sides, so the
only differences are the order of f32 sums: outputs within 2e-5 absolute
(1e-5 relative), cotangents within 1e-4 of each one's max |JAX value| (the
JAX package's own VJP tests hold the Pallas backward to its reference at
1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ait_tpu.ops import pallas_attention as jpa
from ait_tpu.ops import pallas_ffn as jpf
from ait_tpu_torch.ops import fused_attention as pfa
from ait_tpu_torch.ops import fused_ffn as pff
from ait_tpu_torch.ops import philox
from test_torch_train_kernels import (D, DK, H, SHAPES, T, attn_inputs,
                                      close_rel, ffn_inputs)

KEEP = 0.9
SEED = np.asarray([123, -456], np.int32)


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=2e-5)


def attn_masks(seed, p, tq, tk):
    rng = np.random.RandomState(seed)
    return ((rng.rand(H, p * tq, tk) < KEEP).astype(np.float32),
            (rng.rand(p * tq, D) < KEEP).astype(np.float32))


def jax_vjp(fn, primals, g):
    out, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in primals])
    return out, vjp(jnp.asarray(g))


def port_vjp(fn, primals, g):
    ts = [T(a).requires_grad_() for a in primals]
    out = fn(*ts)
    return out, torch.autograd.grad(out, ts, T(g))


ATTN_GRADS = ["dxq", "dxkv", "dwq", "dwk", "dwv", "dsk_w", "dsk_b", "dfc_w",
              "dln_s", "dln_b"]


@pytest.mark.parametrize("tq,tk,kind", SHAPES)
def test_attention_plain_with_masks_matches_reference_impl(tq, tk, kind):
    args, mask, g = attn_inputs(10, 4, tq, tk, kind)
    ak, ok = attn_masks(11, 4, tq, tk)
    out_j, want = jax_vjp(lambda *a: jpa._reference_impl(
        *a, jnp.asarray(mask), jnp.asarray(ak), jnp.asarray(ok), n_head=H,
        d_k=DK, d_v=DK, dist="softmax", keep_prob=KEEP), args, g)
    out_p, got = port_vjp(lambda *a: pfa.sh_attention_reference(
        *a, T(mask), H, DK, DK, attn_keep=T(ak), out_keep=T(ok),
        keep_prob=KEEP), args, g)
    close(out_p, out_j)
    for name, gv, wv in zip(ATTN_GRADS, got, want):
        close_rel(gv, wv, name=name)


@pytest.mark.parametrize("tq,tk,kind", SHAPES)
def test_attention_operand_masks_match_pallas_interpret(tq, tk, kind):
    """The port's fused_sh_attention_dropout (its CPU path: the plain
    forward and torch autograd) against the Pallas kernel with the same
    operand masks, forward and its fused backward."""
    args, mask, g = attn_inputs(12, 4, tq, tk, kind)
    ak, ok = attn_masks(13, 4, tq, tk)
    out_j, want = jax_vjp(lambda *a: jpa.fused_sh_attention_dropout(
        *a, jnp.asarray(mask), jnp.asarray(ak), jnp.asarray(ok), H, DK, DK,
        "softmax", KEEP, 2, True), args, g)
    out_p, got = port_vjp(lambda *a: pfa.fused_sh_attention_dropout(
        *a, T(mask), T(ak), T(ok), H, DK, DK, KEEP), args, g)
    close(out_p, out_j)
    for name, gv, wv in zip(ATTN_GRADS, got, want):
        close_rel(gv, wv, name=name)


def test_attention_rngdrop_matches_pallas_interpret_keep_all():
    """fused_sh_attention_rngdrop in interpret mode (every mask keeps all)
    against the port's plain version with all-ones masks at keep_prob 0.9,
    forward and VJP."""
    tq, tk, kind = 64, 56, "pad"
    args, mask, g = attn_inputs(14, 4, tq, tk, kind)
    ones = (np.ones((H, 4 * tq, tk), np.float32),
            np.ones((4 * tq, D), np.float32))
    out_j, want = jax_vjp(lambda *a: jpa.fused_sh_attention_rngdrop(
        *a, jnp.asarray(mask), jnp.asarray(SEED), H, DK, DK, "softmax", KEEP,
        2, True), args, g)
    out_p, got = port_vjp(lambda *a: pfa.sh_attention_reference(
        *a, T(mask), H, DK, DK, attn_keep=T(ones[0]), out_keep=T(ones[1]),
        keep_prob=KEEP), args, g)
    close(out_p, out_j)
    for name, gv, wv in zip(ATTN_GRADS, got, want):
        close_rel(gv, wv, name=name)


def test_attention_seeded_function_is_the_plain_version_on_its_masks():
    """The port's rngdrop Function on the CPU draws the Philox stream's
    masks for its seed: exactly the plain version fed those masks."""
    tq, tk, kind = 56, 56, "pad"
    args, mask, g = attn_inputs(15, 3, tq, tk, kind)
    seed = T(SEED)
    ak = philox.keep_mask(seed, philox.TAG_ATTN, H, 3, tq * tk, KEEP)
    ok = philox.keep_mask(seed, philox.TAG_OUT, 1, 3, tq * D, KEEP)
    out_s, got = port_vjp(lambda *a: pfa.fused_sh_attention_rngdrop(
        *a, T(mask), seed, H, DK, DK, KEEP), args, g)
    out_m, want = port_vjp(lambda *a: pfa.sh_attention_reference(
        *a, T(mask), H, DK, DK, attn_keep=ak.view(H, 3 * tq, tk),
        out_keep=ok.view(3 * tq, D), keep_prob=KEEP), args, g)
    assert torch.equal(out_s, out_m)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # and the masks matter
    assert not torch.equal(out_s, pfa.sh_attention_reference(
        *[T(a) for a in args], T(mask), H, DK, DK))


FFN_GRADS = ["dx", "dw1", "db1", "dw2", "db2", "dln_s", "dln_b"]


def test_ffn_plain_with_mask_matches_ffn_reference():
    args = ffn_inputs(16, 128)
    keep = (np.random.RandomState(17).rand(128, D) < KEEP).astype(np.float32)
    g = np.random.RandomState(18).randn(128, D).astype(np.float32)
    out_j, want = jax_vjp(lambda *a: jpf.ffn_reference(
        *a, keep=jnp.asarray(keep), keep_prob=KEEP), args, g)
    out_p, got = port_vjp(lambda *a: pff.ffn_reference(
        *a, keep=T(keep), keep_prob=KEEP), args, g)
    close(out_p, out_j)
    for name, gv, wv in zip(FFN_GRADS, got, want):
        close_rel(gv, wv, name=name)


def test_ffn_seed_matches_pallas_interpret_keep_all():
    """fused_ffn with a seed at keep_prob 0.9 in interpret mode (keep all)
    and its _ffn_bwd against the port's FusedFFN with an all-ones mask."""
    args = ffn_inputs(19, 128)
    g = np.random.RandomState(20).randn(128, D).astype(np.float32)
    out_j, want = jax_vjp(lambda *a: jpf.fused_ffn(
        *a, jnp.asarray(SEED), KEEP, True), args, g)
    ones = torch.ones(128, D)
    out_p, got = port_vjp(lambda *a: pff.ffn(*a, keep=ones, keep_prob=KEEP),
                          args, g)
    close(out_p, out_j)
    for name, gv, wv in zip(FFN_GRADS, got, want):
        close_rel(gv, wv, name=name)


def test_ffn_seeded_function_is_the_plain_version_on_its_mask():
    args = ffn_inputs(21, 96)
    g = np.random.RandomState(22).randn(96, D).astype(np.float32)
    seed = T(SEED)
    keep = philox.keep_mask(seed, philox.TAG_FFN, 1, 96, D, KEEP)[0]
    out_s, got = port_vjp(lambda *a: pff.ffn(*a, keep_prob=KEEP, seed=seed),
                          args, g)
    out_m, want = port_vjp(lambda *a: pff.ffn_reference(
        *a, keep=keep, keep_prob=KEEP), args, g)
    assert torch.equal(out_s, out_m)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def posln_inputs(seed, n, t):
    rng = np.random.RandomState(seed)
    return [rng.randn(n, D).astype(np.float32),
            rng.randn(t, D).astype(np.float32),
            (1 + 0.1 * rng.randn(D)).astype(np.float32),
            (0.1 * rng.randn(D)).astype(np.float32)]


@pytest.mark.parametrize("n,t", [(56 * 4, 56), (64 * 2, 64)])
def test_posln_plain_with_mask_matches_posln_reference(n, t):
    x, pos, s, b = posln_inputs(23, n, t)
    keep = (np.random.RandomState(24).rand(n, D) < KEEP).astype(np.float32)
    g = np.random.RandomState(25).randn(n, D).astype(np.float32)
    out_j, want = jax_vjp(lambda x_, s_, b_: jpf.posln_reference(
        x_, jnp.asarray(pos), s_, b_, keep=jnp.asarray(keep),
        keep_prob=KEEP), (x, s, b), g)
    out_p, got = port_vjp(lambda x_, s_, b_: pff.posln_reference(
        x_, T(pos), s_, b_, keep=T(keep), keep_prob=KEEP), (x, s, b), g)
    close(out_p, out_j)
    for name, gv, wv in zip(["dx", "dln_s", "dln_b"], got, want):
        close_rel(gv, wv, name=name)


@pytest.mark.parametrize("n,t", [(56 * 4, 56), (64 * 2, 64)])
def test_posln_seed_matches_pallas_interpret_keep_all(n, t):
    """fused_posln with a seed at keep_prob 0.9 in interpret mode (keep all)
    and _posln_vjp_bwd against the port's FusedPosLN with an all-ones mask;
    the position table's cotangent is zero on both sides."""
    args = posln_inputs(26, n, t)
    g = np.random.RandomState(27).randn(n, D).astype(np.float32)
    out_j, want = jax_vjp(lambda *a: jpf.fused_posln(
        *a, jnp.asarray(SEED), KEEP, True), args, g)
    ones = torch.ones(n, D)
    out_p, got = port_vjp(lambda *a: pff.posln(*a, keep=ones,
                                               keep_prob=KEEP), args, g)
    close(out_p, out_j)
    for name, gv, wv in zip(["dx", "dpos", "dln_s", "dln_b"], got, want):
        close_rel(gv, wv, name=name)
    assert not got[1].any()


def test_posln_seeded_function_is_the_plain_version_on_its_mask():
    args = posln_inputs(28, 56 * 3, 56)
    g = np.random.RandomState(29).randn(56 * 3, D).astype(np.float32)
    seed = T(SEED)
    keep = philox.keep_mask(seed, philox.TAG_GLUE, 1, 56 * 3, D, KEEP)[0]
    out_s, got = port_vjp(lambda *a: pff.posln(*a, keep_prob=KEEP,
                                               seed=seed), args, g)
    out_m, want = port_vjp(lambda *a: pff.posln_reference(
        *a, keep=keep, keep_prob=KEEP), args, g)
    assert torch.equal(out_s, out_m)
    # x, ln_s, ln_b (the Function gives the fixed position table zeros)
    assert all(torch.equal(got[i], want[i]) for i in (0, 2, 3))
