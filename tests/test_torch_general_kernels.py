"""The fused attention's long-sequence and 65-128 token regimes and its
save-qkv policy: the port's plain versions (what its wrappers run on CPU
tensors, and what its CUDA kernels are held against on the card) against the
JAX package's Pallas kernels in interpret mode, as the JAX package's own
tests run them (tests/test_pallas_attention.py:47-88).

Narrow widths (4 heads x 32, d_model 128) keep the interpret runs short;
float32 on both sides, inputs from a numpy seed.  Tolerances are the JAX
tests' own: forward 2e-5 absolute (1e-5 relative), cotangents 2e-3 absolute
and 1e-3 relative; the saved per-head arrays 2e-5 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ait_tpu.ops import pallas_attention as jpa
from ait_tpu_torch.ops import fused_attention as pfa

H, DK, D, P = 4, 32, 128, 2
# (Tq, Tk, mask, JAX pair tile): the co-attention's shape classes (long
# unaligned queries, long unaligned keys, JAX's own VJP shape) at pair_tile 1
# as max(1, 2048 // 1900) gives, then the 65-128 token shapes
LONG = [(150, 64, "full", 1), (64, 150, "full", 1), (100, 48, "full", 1)]
MID = [(96, 128, "causal", 2), (128, 72, "pad", 2)]
NAMES = ["dxq", "dxkv", "dwq", "dwk", "dwv", "dsk_w", "dsk_b", "dfc_w",
         "dln_s", "dln_b"]


def T(a):
    return torch.from_numpy(np.array(a))


def inputs(seed, tq, tk, kind):
    rng = np.random.RandomState(seed)

    def arr(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    args = [arr(P, tq, D), arr(P, tk, D), arr(D, H * DK, scale=D ** -0.5),
            arr(D, H * DK, scale=D ** -0.5), arr(D, H * DK, scale=D ** -0.5),
            arr(DK, H * DK, scale=DK ** -0.5), arr(H * DK, scale=0.05),
            arr(DK, D, scale=DK ** -0.5),
            (1 + 0.1 * rng.randn(D)).astype(np.float32),
            (0.1 * rng.randn(D)).astype(np.float32)]
    if kind == "causal":
        mask = np.tril(np.ones((tq, tk), bool))
    elif kind == "pad":
        mask = np.broadcast_to(np.arange(tk) < tk - 9, (tq, tk)).copy()
    else:
        mask = np.ones((tq, tk), bool)
    return args, mask, arr(P, tq, D)


@pytest.mark.parametrize("tq,tk,kind,tile", LONG + MID)
def test_forward_matches_pallas(tq, tk, kind, tile):
    args, mask, _ = inputs(0, tq, tk, kind)
    want = jpa.fused_sh_attention(*[jnp.asarray(a) for a in args],
                                  jnp.asarray(mask), H, DK, DK, "softmax",
                                  tile, True)
    got = pfa.fused_sh_attention(*[T(a) for a in args], T(mask), H, DK, DK)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=2e-5)


@pytest.mark.parametrize("tq,tk,kind,tile", LONG + MID)
def test_saved_head_outputs_match_pallas(tq, tk, kind, tile):
    """The train forward: the per-head outputs, which JAX keeps 4-D
    [H, P, Tq, d_v] where Tq is not a multiple of 8 (`_oh_4d`) and the port
    always as [H, P*Tq, d_v], the same memory."""
    args, mask, _ = inputs(1, tq, tk, kind)
    want_out, want_oh = jpa._fused_call(
        *[jnp.asarray(a) for a in args], jnp.asarray(mask), n_head=H, d_k=DK,
        d_v=DK, dist="softmax", keep_prob=1.0, pair_tile=tile,
        interpret=True, save_oh=True)
    out, oh = pfa.fused_sh_attention_saved(*[T(a) for a in args], T(mask),
                                           n_head=H, d_k=DK, d_v=DK)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=1e-5,
                               atol=2e-5)
    np.testing.assert_allclose(
        oh.numpy(), np.asarray(want_oh).reshape(H, P * tq, DK), rtol=0,
        atol=2e-5)


@pytest.mark.parametrize("tq,tk,kind,tile", LONG + MID)
def test_backward_matches_pallas_vjp(tq, tk, kind, tile):
    args, mask, g = inputs(2, tq, tk, kind)
    jargs = [jnp.asarray(a) for a in args]
    _, vjp = jax.vjp(lambda *a: jpa.fused_sh_attention(
        *a, jnp.asarray(mask), H, DK, DK, "softmax", tile, True), *jargs)
    want = vjp(jnp.asarray(g))
    got = pfa.fused_sh_attention_bwd(*[T(a) for a in args], T(mask), None,
                                     T(g), n_head=H, d_k=DK, d_v=DK)
    for name, gv, wv in zip(NAMES, got, want):
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-3,
                                   atol=2e-3, err_msg=name)


@pytest.mark.parametrize("tq,tk,kind", [(96, 128, "causal"), (56, 56, "pad")])
def test_save_qkv_outputs_match_pallas(tq, tk, kind):
    """The plain save-qkv outputs against the arrays JAX's forward saves
    under `save_qkv` (q after the 1 / sqrt(d_k) scale, k, v, per head)."""
    args, mask, _ = inputs(3, tq, tk, kind)
    _, want_oh, *want = jpa._fused_call(
        *[jnp.asarray(a) for a in args], jnp.asarray(mask), n_head=H, d_k=DK,
        d_v=DK, dist="softmax", keep_prob=1.0, pair_tile=2, interpret=True,
        save_oh=True, save_qkv=True)
    _, oh, qkv = pfa.fused_sh_attention_saved(
        *[T(a) for a in args], T(mask), n_head=H, d_k=DK, d_v=DK,
        save_qkv=True)
    np.testing.assert_allclose(oh.numpy(), np.asarray(want_oh).reshape(
        H, P * tq, DK), rtol=0, atol=2e-5)
    for name, got, w, t in zip("qkv", qkv, want, (tq, tk, tk)):
        assert got.dtype == torch.float32 and tuple(got.shape) == (H, P * t, DK)
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(w).reshape(H, P * t, DK),
                                   rtol=0, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("tq,tk,kind", [(96, 128, "causal"), (56, 56, "pad")])
def test_save_qkv_gradients_match_pallas(tq, tk, kind, monkeypatch):
    """With JAX's `_SAVE_QKV` on (its backward then reads the saved q/k/v),
    its interpret-mode gradients equal the port's plain backward, and the
    port's Function under its own `_SAVE_QKV` gives the same gradients as
    without."""
    args, mask, g = inputs(4, tq, tk, kind)
    monkeypatch.setattr(jpa, "_SAVE_QKV", True)
    assert jpa._save_qkv_ok(tq, tk)
    jargs = [jnp.asarray(a) for a in args]
    _, vjp = jax.vjp(lambda *a: jpa.fused_sh_attention(
        *a, jnp.asarray(mask), H, DK, DK, "softmax", 2, True), *jargs)
    want = vjp(jnp.asarray(g))

    def port_grads():
        ts = [T(a).requires_grad_() for a in args]
        out = pfa.sh_attention(*ts, T(mask), H, DK, DK)
        return torch.autograd.grad(out, ts, T(g))

    plain = port_grads()
    saved_calls = []
    real = pfa.fused_sh_attention_bwd
    monkeypatch.setattr(pfa, "_SAVE_QKV", True)
    monkeypatch.setattr(pfa, "fused_sh_attention_bwd", lambda *a, **k: (
        saved_calls.append(k.get("qkv")), real(*a, **k))[1])
    with_qkv = port_grads()
    assert len(saved_calls) == 1 and saved_calls[0] is not None
    assert [tuple(t.shape) for t in saved_calls[0]] == [
        (H, P * tq, DK), (H, P * tk, DK), (H, P * tk, DK)]
    for name, a, b, wv in zip(NAMES, with_qkv, plain, want):
        assert torch.equal(a, b), name
        np.testing.assert_allclose(a.numpy(), np.asarray(wv), rtol=1e-3,
                                   atol=2e-3, err_msg=name)


def test_save_qkv_never_in_the_long_regime(monkeypatch):
    """`_save_qkv_ok`: only where both sides are <= 128 tokens, as JAX's."""
    monkeypatch.setattr(pfa, "_SAVE_QKV", True)
    monkeypatch.setattr(jpa, "_SAVE_QKV", True)
    for tq, tk in [(64, 64), (128, 128), (129, 64), (64, 1900), (1900, 64)]:
        assert pfa._save_qkv_ok(tq, tk) == jpa._save_qkv_ok(tq, tk), (tq, tk)
    monkeypatch.setattr(pfa, "_SAVE_QKV", False)
    assert not pfa._save_qkv_ok(64, 64)
    args, mask, g = inputs(5, 150, 64, "full")
    monkeypatch.setattr(pfa, "_SAVE_QKV", True)
    seen = []
    real = pfa.fused_sh_attention_saved
    monkeypatch.setattr(pfa, "fused_sh_attention_saved", lambda *a, **k: (
        seen.append(k["save_qkv"]), real(*a, **k))[1])
    ts = [T(a).requires_grad_() for a in args]
    pfa.sh_attention(*ts, T(mask), H, DK, DK).sum().backward()
    assert seen == [False]
