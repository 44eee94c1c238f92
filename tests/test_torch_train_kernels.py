"""The train path's fused Functions on the CPU (their plain versions: the
forward references and torch autograd through them) against the JAX
package's custom VJPs run through its Pallas kernels in interpret mode:
fused_sh_attention (forward with saved per-head outputs, `_fused_bwd_call`),
fused_ffn (`_ffn_bwd`) and fused_posln (`_posln_vjp_bwd`).

Narrow widths keep the interpret runs short.  float32 on both sides, so
the only differences are the order of f32 sums; cotangents are compared
within 1e-4 of each one's max |JAX value| (the JAX package's own VJP tests
hold the Pallas backward to its jnp reference at 1e-4, tests/
test_pallas_attention.py), the saved per-head outputs within 2e-5.
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

REL = 1e-4
H, DK, D = 4, 32, 128
SHAPES = [(56, 56, "pad"), (64, 64, "causal"), (64, 56, "pad")]


def T(a):
    return torch.from_numpy(np.array(a))


def close_rel(got, want, rel=REL, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, name
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(scale, 1e-30),
                               err_msg=name)


def attn_inputs(seed, p, tq, tk, kind):
    rng = np.random.RandomState(seed)

    def arr(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    xq = arr(p, tq, D)
    xkv = xq if tq == tk else arr(p, tk, D)
    args = [xq, xkv, arr(D, H * DK, scale=D ** -0.5),
            arr(D, H * DK, scale=D ** -0.5), arr(D, H * DK, scale=D ** -0.5),
            arr(DK, H * DK, scale=DK ** -0.5), arr(H * DK, scale=0.05),
            arr(DK, D, scale=DK ** -0.5),
            (1 + 0.1 * rng.randn(D)).astype(np.float32),
            (0.1 * rng.randn(D)).astype(np.float32)]
    if kind == "causal":
        mask = np.tril(np.ones((tq, tk), bool))
    else:
        mask = np.broadcast_to(np.arange(tk) < 49, (tq, tk)).copy()
    g = arr(p, tq, D)
    return args, mask, g


@pytest.mark.parametrize("tq,tk,kind", SHAPES)
def test_saved_head_outputs_match_pallas(tq, tk, kind):
    """Kernel A's plain version: the output and the per-head outputs
    against _fused_call(save_oh=True) in interpret mode."""
    args, mask, _ = attn_inputs(0, 4, tq, tk, kind)
    want_out, want_oh = jpa._fused_call(
        *[jnp.asarray(a) for a in args], jnp.asarray(mask), n_head=H, d_k=DK,
        d_v=DK, dist="softmax", keep_prob=1.0, pair_tile=2, interpret=True,
        save_oh=True)
    out, oh = pfa.fused_sh_attention_saved(*[T(a) for a in args], T(mask),
                                           n_head=H, d_k=DK, d_v=DK)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=1e-5,
                               atol=2e-5)
    np.testing.assert_allclose(oh.numpy(), np.asarray(want_oh), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("tq,tk,kind", SHAPES)
def test_attention_backward_matches_pallas_vjp(tq, tk, kind):
    """sh_attention_bwd_reference (the plain version of kernel D) against
    the custom VJP of fused_sh_attention through _fused_bwd_call."""
    args, mask, g = attn_inputs(1, 4, tq, tk, kind)
    jargs = [jnp.asarray(a) for a in args]
    # x_q and x_kv as separate primals: their cotangents come back apart
    _, vjp = jax.vjp(lambda *a: jpa.fused_sh_attention(
        *a, jnp.asarray(mask), H, DK, DK, "softmax", 2, True), *jargs)
    want = vjp(jnp.asarray(g))
    got = pfa.sh_attention_bwd_reference(*[T(a) for a in args], T(mask),
                                         None, T(g), n_head=H, d_k=DK,
                                         d_v=DK)
    names = ["dxq", "dxkv", "dwq", "dwk", "dwv", "dsk_w", "dsk_b", "dfc_w",
             "dln_s", "dln_b"]
    for name, gv, wv in zip(names, got, want):
        close_rel(gv, wv, name=name)


def test_attention_function_self_attention_sums_cotangents():
    """FusedSHAttention through autograd with one tensor as x_q and x_kv
    (encoder self-attention): the input gradient is the sum of both
    cotangents, as JAX's is."""
    args, mask, g = attn_inputs(2, 3, 56, 56, "pad")
    jargs = [jnp.asarray(a) for a in args]

    def jf(x, *w):
        return jpa.fused_sh_attention(x, x, *w, jnp.asarray(mask), H, DK, DK,
                                      "softmax", 1, True)

    _, vjp = jax.vjp(jf, jargs[0], *jargs[2:])
    want = vjp(jnp.asarray(g))
    ts = [T(a).requires_grad_() for a in [args[0]] + args[2:]]
    out = pfa.sh_attention(ts[0], ts[0], *ts[1:], T(mask), H, DK, DK)
    got = torch.autograd.grad(out, ts, T(g))
    for i, (gv, wv) in enumerate(zip(got, want)):
        close_rel(gv, wv, name=f"cotangent {i}")


def test_attention_dispatch_without_grad_runs_the_eval_forward(monkeypatch):
    """No input needs a gradient: the eval forward, no per-head outputs."""
    args, mask, _ = attn_inputs(3, 2, 64, 64, "causal")
    monkeypatch.setattr(pfa, "fused_sh_attention_saved", lambda *a, **k:
                        pytest.fail("the train forward ran without grad"))
    out = pfa.sh_attention(*[T(a) for a in args], T(mask), H, DK, DK)
    assert not out.requires_grad


def ffn_inputs(seed, n, d=D, hid=256):
    rng = np.random.RandomState(seed)
    return [rng.randn(n, d).astype(np.float32),
            (rng.randn(d, hid) * d ** -0.5).astype(np.float32),
            (0.05 * rng.randn(hid)).astype(np.float32),
            (rng.randn(hid, d) * hid ** -0.5).astype(np.float32),
            (0.05 * rng.randn(d)).astype(np.float32),
            (1 + 0.1 * rng.randn(d)).astype(np.float32),
            (0.1 * rng.randn(d)).astype(np.float32)]


@pytest.mark.parametrize("n", [128, 192])
def test_ffn_backward_matches_pallas_vjp(n):
    """ffn_bwd_reference (the plain version of kernel B) against the
    custom VJP of fused_ffn through _ffn_bwd (keep_prob 1)."""
    args = ffn_inputs(4, n)
    g = np.random.RandomState(5).randn(n, D).astype(np.float32)
    seed = jnp.zeros((2,), jnp.int32)
    _, vjp = jax.vjp(lambda *a: jpf.fused_ffn(*a, seed, 1.0, True),
                     *[jnp.asarray(a) for a in args])
    want = vjp(jnp.asarray(g))
    got = pff.ffn_bwd_reference(*[T(a) for a in args], T(g))
    for name, gv, wv in zip(["dx", "dw1", "db1", "dw2", "db2", "dln_s",
                             "dln_b"], got, want):
        close_rel(gv, wv, name=name)


def test_ffn_function_matches_pallas_vjp():
    """FusedFFN through autograd: forward and every cotangent."""
    args = ffn_inputs(6, 64)
    g = np.random.RandomState(7).randn(64, D).astype(np.float32)
    seed = jnp.zeros((2,), jnp.int32)
    out_j, vjp = jax.vjp(lambda *a: jpf.fused_ffn(*a, seed, 1.0, True),
                         *[jnp.asarray(a) for a in args])
    ts = [T(a).requires_grad_() for a in args]
    out = pff.ffn(*ts)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               rtol=1e-5, atol=2e-5)
    for i, (gv, wv) in enumerate(zip(torch.autograd.grad(out, ts, T(g)),
                                     vjp(jnp.asarray(g)))):
        close_rel(gv, wv, name=f"cotangent {i}")


@pytest.mark.parametrize("n,t", [(56 * 4, 56), (64 * 2, 64)])
def test_posln_backward_matches_pallas_vjp(n, t):
    """posln_bwd_reference (the plain version of kernel C) and FusedPosLN
    against the custom VJP of fused_posln through _posln_vjp_bwd: dx,
    dln_s, dln_b, and a zero gradient for the position table."""
    rng = np.random.RandomState(8)
    x = rng.randn(n, D).astype(np.float32)
    pos = rng.randn(t, D).astype(np.float32)
    ln_s = (1 + 0.1 * rng.randn(D)).astype(np.float32)
    ln_b = (0.1 * rng.randn(D)).astype(np.float32)
    g = rng.randn(n, D).astype(np.float32)
    seed = jnp.zeros((2,), jnp.int32)
    _, vjp = jax.vjp(lambda *a: jpf.fused_posln(*a, seed, 1.0, True),
                     *[jnp.asarray(a) for a in (x, pos, ln_s, ln_b)])
    want = vjp(jnp.asarray(g))
    got = pff.posln_bwd_reference(T(x), T(pos), T(ln_s), T(ln_b), T(g))
    for name, gv, wv in zip(["dx", "dpos", "dln_s", "dln_b"], got, want):
        close_rel(gv, wv, name=name)
    assert not got[1].any()
    ts = [T(a).requires_grad_() for a in (x, pos, ln_s, ln_b)]
    fgot = torch.autograd.grad(pff.posln(*ts), ts, T(g))
    for name, gv, wv in zip(["dx", "dpos", "dln_s", "dln_b"], fgot, want):
        close_rel(gv, wv, name=name)
