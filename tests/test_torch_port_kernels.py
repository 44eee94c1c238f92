"""The plain versions beside the port's CUDA kernels against the JAX
package's jnp references and its Pallas kernels (interpret mode), on the
CPU.  (The wrappers' dispatch: tests/test_torch_port_dispatch.py.)

Narrow widths keep the interpret runs short.  float32 on both sides, so the
only differences are the order of f32 sums: 2e-5 (as tests/
test_pallas_attention.py).  The bfloat16 case rounds at the same points on
both sides; sums in another order can move a rounding by one bf16 ulp, and
the outputs are LayerNormed (unit scale), so 2 ulps of a value below 8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ait_tpu.ops import pallas_attention as jpa
from ait_tpu.ops import pallas_ffn as jpf
from ait_tpu_torch.ops import fused_attention as pfa
from ait_tpu_torch.ops import fused_ffn as pff

F32_TOL = dict(rtol=1e-5, atol=2e-5)
BF16_TOL = dict(rtol=0.0, atol=2 * 2.0 ** -5)

SHAPES = [(56, 56, "pad"), (56, 56, "full"), (56, 56, "causal"),
          (64, 64, "causal"), (64, 64, "pad"), (64, 64, "full"),
          (64, 56, "pad"), (64, 56, "full")]


def attn_inputs(seed, p, tq, tk, d, h, dk, kind):
    rng = np.random.RandomState(seed)

    def arr(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    xq = arr(p, tq, d)
    xkv = xq if tq == tk else arr(p, tk, d)
    args = [xq, xkv, arr(d, h * dk, scale=d ** -0.5),
            arr(d, h * dk, scale=d ** -0.5), arr(d, h * dk, scale=d ** -0.5),
            arr(dk, h * dk, scale=dk ** -0.5), arr(h * dk, scale=0.05),
            arr(dk, d, scale=dk ** -0.5),
            (1 + 0.1 * rng.randn(d)).astype(np.float32),
            (0.1 * rng.randn(d)).astype(np.float32)]
    if kind == "causal":
        mask = np.tril(np.ones((tq, tk), bool))
    elif kind == "pad":
        mask = np.broadcast_to(np.arange(tk) < 49, (tq, tk)).copy()
    else:
        mask = np.ones((tq, tk), bool)
    return args, mask


def port_attention(args, mask, h, dk, dtype=torch.float32):
    t = [torch.from_numpy(a).to(dtype) for a in args[:8]]
    t += [torch.from_numpy(a) for a in args[8:]]
    return pfa.fused_sh_attention(*t, torch.from_numpy(mask), n_head=h,
                                  d_k=dk, d_v=dk)


@pytest.mark.parametrize("tq,tk,kind", SHAPES)
def test_attention_plain_matches_jnp_reference(tq, tk, kind):
    h, dk, d = 4, 32, 128
    args, mask = attn_inputs(0, 3, tq, tk, d, h, dk, kind)
    want = jpa._reference_impl(*[jnp.asarray(a) for a in args],
                               jnp.asarray(mask), n_head=h, d_k=dk, d_v=dk,
                               dist="softmax")
    got = port_attention(args, mask, h, dk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("tq,tk,kind", SHAPES)
def test_attention_plain_matches_pallas_interpret(tq, tk, kind):
    h, dk, d = 4, 32, 128
    args, mask = attn_inputs(1, 4, tq, tk, d, h, dk, kind)
    want = jpa.fused_sh_attention(*[jnp.asarray(a) for a in args],
                                  jnp.asarray(mask), h, dk, dk, "softmax",
                                  2, True)
    got = port_attention(args, mask, h, dk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_attention_plain_bf16_matches_jnp_reference():
    h, dk, d = 8, 64, 512
    args, mask = attn_inputs(2, 2, 64, 56, d, h, dk, "pad")
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in args[:8]]
    jargs += [jnp.asarray(a) for a in args[8:]]
    want = jpa._reference_impl(*jargs, jnp.asarray(mask), n_head=h, d_k=dk,
                               d_v=dk, dist="softmax")
    got = port_attention(args, mask, h, dk, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **BF16_TOL)


def ffn_inputs(seed, n, d, hid):
    rng = np.random.RandomState(seed)
    return [rng.randn(n, d).astype(np.float32),
            (rng.randn(d, hid) * d ** -0.5).astype(np.float32),
            (0.05 * rng.randn(hid)).astype(np.float32),
            (rng.randn(hid, d) * hid ** -0.5).astype(np.float32),
            (0.05 * rng.randn(d)).astype(np.float32),
            (1 + 0.1 * rng.randn(d)).astype(np.float32),
            (0.1 * rng.randn(d)).astype(np.float32)]


@pytest.mark.parametrize("n", [64, 192])
def test_ffn_plain_matches_jnp_and_pallas_interpret(n):
    args = ffn_inputs(n, n, 128, 256)
    jargs = [jnp.asarray(a) for a in args]
    got = pff.fused_ffn(*[torch.from_numpy(a) for a in args]).numpy()
    np.testing.assert_allclose(got, np.asarray(jpf.ffn_reference(*jargs)),
                               **F32_TOL)
    kern = jpf.fused_ffn(*jargs, jnp.zeros((2,), jnp.int32), 1.0, True)
    np.testing.assert_allclose(got, np.asarray(kern), **F32_TOL)


def test_ffn_plain_bf16_matches_jnp_reference():
    args = ffn_inputs(5, 128, 512, 2048)
    jargs = [jnp.asarray(a, jnp.bfloat16) if i in (0, 1, 3) else
             jnp.asarray(a) for i, a in enumerate(args)]
    targs = [torch.from_numpy(a).to(torch.bfloat16) if i in (0, 1, 3) else
             torch.from_numpy(a) for i, a in enumerate(args)]
    want = jpf.ffn_reference(*jargs)
    got = pff.fused_ffn(*targs)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **BF16_TOL)


@pytest.mark.parametrize("n,t", [(56 * 6, 56), (64 * 3, 64)])
def test_posln_plain_matches_jnp_and_pallas_interpret(n, t):
    rng = np.random.RandomState(t)
    d = 128
    x = rng.randn(n, d).astype(np.float32)
    pos = rng.randn(t, d).astype(np.float32)
    s = (1 + 0.1 * rng.randn(d)).astype(np.float32)
    b = (0.1 * rng.randn(d)).astype(np.float32)
    got = pff.fused_posln(*(torch.from_numpy(a) for a in (x, pos, s, b)))
    jargs = [jnp.asarray(a) for a in (x, pos, s, b)]
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jpf.posln_reference(*jargs)),
                               **F32_TOL)
    kern = jpf.fused_posln(*jargs, jnp.zeros((2,), jnp.int32), 1.0, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), **F32_TOL)
