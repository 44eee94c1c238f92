"""The redesigned forward route of the short attention regime, on the CPU:
the projections over all pairs (`project`, csrc/gemm.cu's products on the
card) and then the per-pair core (`short_core`, csrc/sh_attention.cu).

* Its plain form, `project` and `sh_attention_core_reference` in float32,
  against the block's plain version `sh_attention_reference` and against
  ait_tpu's Pallas kernel run in interpret mode, in every mode of the
  forward: eval, the saved per-head outputs, operand dropout masks, and the
  save-qkv outputs.  Narrow widths keep the interpret runs short; float32 on
  every side, so only the order of f32 sums differs: 2e-5 absolute (1e-5
  relative), as tests/test_torch_port_kernels.py.
* The launches of a call off the CPU, with a stand-in for the built
  library: three products with the operands' shapes and pointers, then one
  core launch on exactly their outputs; and a CPU tensor never builds a
  kernel.
* `gpu`-marked: both redesigned kernels (the attention core and the FFN's
  tensor-core forward, csrc/ffn.cu) against their plain versions on the
  card.  This file imports JAX only inside the tests that compare with it,
  so on a machine with a GPU and no JAX the card tests run with

    python -m pytest --noconftest -m gpu tests/test_torch_fwd_redesign.py
"""

import numpy as np
import pytest
import torch

from ait_tpu_torch.ops import _build, _gemm
from ait_tpu_torch.ops import fused_attention as pfa
from ait_tpu_torch.ops import fused_ffn as pff

H, DK, D = 4, 32, 128
KEEP = 0.9
SHAPES = [(56, 56, "pad"), (64, 64, "causal"), (64, 56, "pad")]
MODES = ["eval", "save_oh", "masks", "save_qkv"]
CLOSE = dict(rtol=1e-5, atol=2e-5)


def T(a):
    return torch.from_numpy(np.array(a))


def attn_inputs(seed, p, tq, tk, kind, h=H, dk=DK, d=D):
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
    else:
        mask = np.broadcast_to(np.arange(tk) < 49, (tq, tk)).copy()
    keep = ((rng.rand(h, p * tq, tk) < KEEP).astype(np.float32),
            (rng.rand(p * tq, d) < KEEP).astype(np.float32))
    return args, mask, keep


def plain_route(args, mask, mode, keep):
    """`project` then `sh_attention_core_reference`, the kernels' route."""
    t = [T(a) for a in args]
    drop = {}
    if mode == "masks":
        drop = dict(attn_keep=T(keep[0]), out_keep=T(keep[1]), keep_prob=KEEP)
    proj = pfa.project(*t[:5])
    assert [tuple(x.shape) for x in proj] == [
        (t[0].shape[0] * t[0].shape[1], H * DK),
        (t[1].shape[0] * t[1].shape[1], H * DK),
        (t[1].shape[0] * t[1].shape[1], H * DK)]
    return pfa.sh_attention_core_reference(
        *proj, *t[5:8], t[0], *t[8:], T(mask), H, DK, DK,
        return_oh=mode in ("save_oh", "save_qkv"),
        return_qkv=mode == "save_qkv", **drop)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tq,tk,kind", SHAPES)
def test_plain_route_matches_reference_and_pallas(tq, tk, kind, mode):
    jnp = pytest.importorskip("jax.numpy")
    from ait_tpu.ops import pallas_attention as jpa

    p = 4
    args, mask, keep = attn_inputs(7 + tq + tk, p, tq, tk, kind)
    got = plain_route(args, mask, mode, keep)
    got = got if isinstance(got, tuple) else (got,)

    # the block's plain version
    t = [T(a) for a in args]
    drop = {}
    if mode == "masks":
        drop = dict(attn_keep=T(keep[0]), out_keep=T(keep[1]), keep_prob=KEEP)
    ref = pfa.sh_attention_reference(
        *t, T(mask), H, DK, DK, return_oh=mode in ("save_oh", "save_qkv"),
        return_qkv=mode == "save_qkv", **drop)
    ref = ref if isinstance(ref, tuple) else (ref,)
    np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(), **CLOSE)
    if len(ref) > 1:
        np.testing.assert_allclose(got[1].numpy(), ref[1].numpy(), **CLOSE)
    if mode == "save_qkv":
        for a, b in zip(got[2], ref[2]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **CLOSE)

    # ait_tpu's Pallas kernel, interpret mode
    ja = [jnp.asarray(a) for a in args]
    jm = jnp.asarray(mask)
    if mode == "eval":
        want = (jpa.fused_sh_attention(*ja, jm, H, DK, DK, "softmax", 2,
                                       True),)
    elif mode == "masks":
        want = (jpa.fused_sh_attention_dropout(
            *ja, jm, jnp.asarray(keep[0]), jnp.asarray(keep[1]), H, DK, DK,
            "softmax", KEEP, 2, True),)
    else:
        want = jpa._fused_call(*ja, jm, n_head=H, d_k=DK, d_v=DK,
                               dist="softmax", keep_prob=1.0, pair_tile=2,
                               interpret=True, save_oh=True,
                               save_qkv=mode == "save_qkv")
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **CLOSE)
    if mode in ("save_oh", "save_qkv"):
        np.testing.assert_allclose(
            got[1].numpy(), np.asarray(want[1]).reshape(H, p * tq, DK),
            rtol=0, atol=2e-5)
    if mode == "save_qkv":
        for name, a, w, n in zip("qkv", got[2], want[2:], (tq, tk, tk)):
            np.testing.assert_allclose(
                a.numpy(), np.asarray(w).reshape(H, p * n, DK), rtol=0,
                atol=2e-5, err_msg=name)


# ------------------------------------------------------- launches, faked


class FakeLibrary:
    """Stands in for the built csrc/sh_attention.cu: records each entry's
    arguments and returns cudaSuccess."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def fake_kernels(monkeypatch):
    """The launchers' view of a card: the library a stand-in, the products
    recorded (their results are `gemm`'s plain ones: the operands lie on the
    CPU here)."""
    lib = FakeLibrary()
    products = []
    real_gemm = _gemm.gemm

    def gemm(layout, a, b, **kw):
        out = real_gemm(layout, a, b, **kw)
        products.append((layout, a, b, out))
        return out

    monkeypatch.setattr(_build, "load", lambda stem, funcs: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(_gemm, "gemm", gemm)
    return lib, products


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("saved", [False, True])
def test_short_forward_launches_products_then_core(dtype, saved,
                                                   fake_kernels):
    lib, products = fake_kernels
    p, tq, tk = 3, 7, 5
    args, mask, _ = attn_inputs(1, p, tq, tk, "pad", h=8, dk=64, d=512)
    t = [T(a).to(dtype) for a in args[:8]] + [T(a) for a in args[8:]]
    t.append(T(mask))
    oh = torch.empty(8, p * tq, 64) if saved else None
    out, qkv = pfa._forward(t[0], tuple(t), p, tq, tk, "short", oh=oh,
                            save_qkv=saved)
    assert len(products) == 3
    for (layout, a, b, res), x, w, rows in zip(
            products, (t[0], t[1], t[1]), t[2:5], (p * tq, p * tk, p * tk)):
        assert layout == _gemm.NN
        assert a.data_ptr() == x.data_ptr() and tuple(a.shape) == (rows, 512)
        assert b.data_ptr() == w.data_ptr() and tuple(b.shape) == (512, 512)
        assert res.dtype == torch.float32 and tuple(res.shape) == (rows, 512)
    assert [name for name, _ in lib.calls] == ["sh_attention_fwd"]
    a = lib.calls[0][1]
    assert a[0] == int(dtype == torch.bfloat16)
    assert a[1:4] == tuple(r.data_ptr() for r in (x[3] for x in products))
    assert a[4:11] == tuple(x.data_ptr() for x in
                            (t[5], t[6], t[7], t[0], t[8], t[9], t[10]))
    assert a[11] == out.data_ptr() and out.shape == t[0].shape
    assert out.dtype == dtype
    assert a[12] == (oh.data_ptr() if saved else None)
    if saved:
        assert a[13:16] == tuple(x.data_ptr() for x in qkv)
        assert [tuple(x.shape) for x in qkv] == [
            (8, p * tq, 64), (8, p * tk, 64), (8, p * tk, 64)]
    else:
        assert qkv is None and a[13:16] == (None, None, None)
    assert a[16:19] == (p, tq, tk)
    assert a[19:24] == (None, None, None, 0, 1.0)


def _cpu_calls():
    args, mask, keep = attn_inputs(3, 2, 8, 8, "pad", h=8, dk=64, d=512)
    t = [T(a) for a in args] + [T(mask)]
    g = torch.randn(2, 8, 512)
    rng = np.random.RandomState(4)
    f = [T(rng.randn(*s).astype(np.float32) * sc) for s, sc in (
        ((24, 512), 1.0), ((512, 2048), 0.04), ((2048,), 0.05),
        ((2048, 512), 0.02), ((512,), 0.05), ((512,), 1.0), ((512,), 0.1))]
    return {
        "attention": lambda: pfa.fused_sh_attention(*t),
        "attention_saved": lambda: pfa.fused_sh_attention_saved(
            *t, save_qkv=True),
        "attention_bwd": lambda: pfa.fused_sh_attention_bwd(
            *t, torch.zeros(8, 16, 64), g),
        "ffn": lambda: pff.fused_ffn(*f),
        "ffn_dropout": lambda: pff.fused_ffn(
            *f, keep=torch.ones(24, 512), keep_prob=KEEP),
    }


@pytest.mark.parametrize("call", sorted(_cpu_calls()))
def test_cpu_tensor_never_builds_a_kernel(call, monkeypatch):
    monkeypatch.setattr(_build, "load", lambda *a, **k: pytest.fail(
        "a CPU tensor built a kernel"))
    monkeypatch.setattr(_gemm, "_lib", lambda: pytest.fail(
        "a CPU tensor built csrc/gemm.cu"))
    res = _cpu_calls()[call]()
    for x in (res if isinstance(res, tuple) else (res,)):
        for y in (x if isinstance(x, tuple) else (x,)):
            assert y.device.type == "cpu"


# ------------------------------------------------------------- on the card


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["eval", "save_qkv", "seed"])
def test_core_kernel_matches_plain_version_on_gpu(mode, dtype, cuda):
    """`short_core` against `sh_attention_core_reference` on the same
    projections (the kernel's route and cast points): f32 within 2e-3 abs,
    bf16 within 2^-6 of max(1, |plain|) (the output's rounding and the
    gated sum's, apart)."""
    from ait_tpu_torch.ops import dropout_masks as dm

    p, tq, tk = 40, 56, 48
    args, mask, _ = attn_inputs(5, p, tq, tk, "pad", h=8, dk=64, d=512)
    t = [T(a).to(cuda, dtype) for a in args[:8]] + [
        T(a).to(cuda) for a in args[8:]]
    m = T(mask).to(cuda)
    proj = pfa.project(*t[:5])
    drop, plain = pfa._NO_DROP, {}
    if mode == "seed":
        seed = torch.tensor([5, -6], dtype=torch.int32, device=cuda)
        drop = pfa._kernel_drop("core", t[0], p, tq, tk, KEEP, seed, None,
                                None)
        ak, ok = dm.dropout_keep_masks(seed, p, tq, tk, 512, keep_prob=KEEP)
        plain = dict(attn_keep=ak, out_keep=ok, keep_prob=KEEP)
    oh = torch.empty(8, p * tq, 64, device=cuda)
    qkv = None
    if mode == "save_qkv":
        qkv = tuple(torch.empty(8, p * n, 64, device=cuda)
                    for n in (tq, tk, tk))
    out = pfa.short_core(t[0], proj, *t[5:8], *t[8:], m, tk, oh, qkv, drop)
    want = pfa.sh_attention_core_reference(
        *proj, *t[5:8], t[0], *t[8:], m, return_oh=True,
        return_qkv=qkv is not None, **plain)
    torch.cuda.synchronize()
    tol = 2e-3 if dtype == torch.float32 else 2.0 ** -6
    scale = want[0].float().abs().clamp(min=1.0)
    assert ((out.float() - want[0].float()).abs() / scale).max() <= tol
    assert (oh - want[1]).abs().max() <= 2e-3
    if qkv is not None:
        for a, b in zip(qkv, want[2]):
            assert (a - b).abs().max() <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("n", [40, 300])
def test_ffn_tensor_core_kernel_matches_plain_version_on_gpu(n, dropout,
                                                             cuda):
    """The bf16 FFN forward (wgmma + TMA, ragged row tiles) against its plain
    version, the same mask from the seed: within 2^-6 of max(1, |plain|),
    the tolerance chip_smoke.py holds it to."""
    from ait_tpu_torch.ops import dropout_masks as dm

    rng = np.random.RandomState(n)
    bf = torch.bfloat16
    x = T(rng.randn(n, 512).astype(np.float32)).to(cuda, bf)
    w1 = T(rng.randn(512, 2048).astype(np.float32) * 512 ** -0.5).to(cuda, bf)
    b1 = T(0.05 * rng.randn(2048).astype(np.float32)).to(cuda)
    w2 = T(rng.randn(2048, 512).astype(np.float32) * 2048 ** -0.5).to(cuda, bf)
    b2, s, b = (T(v.astype(np.float32)).to(cuda) for v in (
        0.05 * rng.randn(512), 1 + 0.1 * rng.randn(512), 0.1 * rng.randn(512)))
    kw, plain = {}, {}
    if dropout:
        seed = torch.tensor([9, 10], dtype=torch.int32, device=cuda)
        kw = dict(seed=seed, keep_prob=KEEP)
        plain = dict(keep=dm.ffn_keep_mask(seed, n, 512, keep_prob=KEEP),
                     keep_prob=KEEP)
    before = pff.fused_ffn.dropout_launches if dropout else \
        pff.fused_ffn.launches
    got = pff.fused_ffn(x, w1, b1, w2, b2, s, b, **kw)
    torch.cuda.synchronize()
    after = pff.fused_ffn.dropout_launches if dropout else \
        pff.fused_ffn.launches
    assert after == before + 1
    want = pff.ffn_reference(x, w1, b1, w2, b2, s, b, **plain)
    err = ((got.float() - want.float()).abs() /
           want.float().abs().clamp(min=1.0)).max().item()
    assert err <= 2.0 ** -6
