"""The redesigned per-pair attention backward (csrc/sh_attention.cu
`sh_attn_bwd_kernel`, persistent blocks, its products on the tensor cores),
on the CPU.

* Its plain version, `sh_attention_bwd_pairs_reference` (the kernel's
  outputs from the projections, the saved per-head outputs and the output
  cotangent, with the Pallas kernel's cast points), composed with the
  products that `fused_sh_attention_bwd` runs after it (`bwd_products`), in
  float32 against the block's plain backward `sh_attention_bwd_reference`
  (torch autograd) and against ait_tpu's `_fused_bwd_call` run in interpret
  mode: without dropout, with operand dropout masks, and with the saved
  q/k/v.  Narrow widths keep the interpret runs short; float32 on every
  side, so only the order of f32 sums differs: 2e-5 absolute (1e-5
  relative), as tests/test_torch_fwd_redesign.py.
* The numerics of the kernel's per-head products: every f32 operand is the
  sum of its three bf16 terms, and the emulated six-term product
  (`split6_matmul`) stays within SPLIT_BOUND * sum_k |a_k| |b_k| of the
  exact product and of torch's f32 product, where the cheaper three-term
  split (i + j <= 1, emulated here) does not; likewise the per-pair
  outputs with six-term per-head products stay within the card's f32 gate
  PAIR_F32_REL of the plain version, and with three-term ones do not.
* The launches of a backward call, with a stand-in for the built library:
  the three projections, then one per-pair launch on exactly their
  outputs, then the products on the launch's outputs; no projections when
  the forward saved q/k/v; and a CPU tensor never builds a kernel.
* `gpu`-marked: the kernel's per-pair outputs against the plain version on
  the card, the split products against their bound, and a launch counted
  per call.  This file imports JAX only inside the tests that compare with
  it, so on a machine with a GPU and no JAX the card tests run with

    python -m pytest --noconftest -m gpu tests/test_torch_bwd_redesign.py
"""

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from ait_tpu_torch.ops import _build, _gemm
from ait_tpu_torch.ops import fused_attention as pfa

from test_torch_fwd_redesign import FakeLibrary, T, attn_inputs

H, DK, D = 4, 32, 128
KEEP = 0.9
SHAPES = [(56, 56, "pad"), (64, 64, "causal"), (64, 56, "pad")]
MODES = ["saved", "masks", "save_qkv"]
CLOSE = dict(rtol=1e-5, atol=2e-5)
# the per-pair kernel against its plain version on the card, each output
# over its max |plain|: f32 (the six-term split products, near-f32, and the
# order of sums: 1.7e-6 on an H100; the three-term split's emulation
# reaches 7.3e-6 to 1.3e-5, test_pair_f32_gate_tells_six_terms_from_three,
# the six-term one 4.2e-7 to 6.4e-7) and bf16
# (o rounded to bf16 after sums in another order moves a few elements of o
# by an ulp, 2^-8, and everything after it); chip_smoke.py holds the same
PAIR_F32_REL, PAIR_BF16_REL = 5e-6, 2e-2


def _port(args, mask, keep, mode, g, p):
    """(cotangents by the plain per-pair route, by autograd, per-pair
    outputs) in float32."""
    t = [T(a) for a in args]
    m = T(mask)
    drop = {}
    if mode == "masks":
        drop = dict(attn_keep=T(keep[0]), out_keep=T(keep[1]),
                    keep_prob=KEEP)
    out, oh, *rest = pfa.sh_attention_saved_reference(
        *t, m, H, DK, DK, save_qkv=mode == "save_qkv", **drop)
    gt = T(g)
    proj = rest[0] if mode == "save_qkv" else pfa.project(*t[:5])
    pairs = pfa.sh_attention_bwd_pairs_reference(
        *proj, *t[5:8], t[0], t[8], m, oh, gt, H, DK, DK,
        qkv_saved=mode == "save_qkv", **drop)
    got = pfa.bwd_products(*t[:5], pairs)
    want = pfa.sh_attention_bwd_reference(*t, m, oh, gt, H, DK, DK, **drop)
    return got, want, pairs


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tq,tk,kind", SHAPES)
def test_plain_pairs_route_matches_reference_and_pallas(tq, tk, kind, mode):
    jnp = pytest.importorskip("jax.numpy")
    from ait_tpu.ops import pallas_attention as jpa

    p = 4
    args, mask, keep = attn_inputs(11 + tq + tk, p, tq, tk, kind)
    g = np.random.RandomState(tq * tk).randn(p, tq, D).astype(np.float32)
    got, want, pairs = _port(args, mask, keep, mode, g, p)
    assert len(got) == len(want) == 10
    for name, a, b in zip(range(10), got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=str(name),
                                   **CLOSE)
    # the per-pair outputs' shapes, as the kernel writes them
    shapes = [(p * tq, D), (p * tq, DK), (p, DK), (p, H * DK), (2, p, D),
              (p * tq, H * DK), (p * tk, H * DK), (p * tk, H * DK),
              (p * tq, D)]
    assert [tuple(x.shape) for x in pairs] == shapes
    if mode != "masks":
        assert torch.equal(pairs[0], pairs[8])          # dy0 is dy

    # ait_tpu's Pallas backward, interpret mode, from its own forward
    ja = [jnp.asarray(a) for a in args]
    jm = jnp.asarray(mask)
    masks = ((jnp.asarray(keep[0]), jnp.asarray(keep[1])) if mode == "masks"
             else (None, None))
    kp = KEEP if mode == "masks" else 1.0
    fwd = jpa._fused_call(*ja, jm, *masks, n_head=H, d_k=DK, d_v=DK,
                          dist="softmax", keep_prob=kp, pair_tile=2,
                          interpret=True, save_oh=True,
                          save_qkv=mode == "save_qkv")
    jg = jnp.asarray(g)
    jgrads = jpa._fused_bwd_call(
        *ja, jm, *masks, fwd[1], jg, n_head=H, d_k=DK, d_v=DK, keep_prob=kp,
        pair_tile=2, interpret=True,
        qkv=tuple(fwd[2:5]) if mode == "save_qkv" else None)
    for name, a, b in zip(range(10), got, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=str(name),
                                   **CLOSE)


# ------------------------------------------------ the split products


def _values(kind, rng, shape=(4096,)):
    n = int(np.prod(shape))
    if kind == "random":
        v = rng.standard_normal(n)
    elif kind == "tiny":
        v = (1 + rng.random(n)) * 2.0 ** rng.integers(-110, -60, n)
        v[::2] *= -1
    elif kind == "large":
        v = rng.standard_normal(n) * 2.0 ** rng.integers(40, 120, n)
    elif kind == "probabilities":        # a softmax row's spread
        v = np.exp(-30 * rng.random(n))
    else:                                 # mixed magnitudes
        v = rng.standard_normal(n) * 2.0 ** rng.integers(-20, 20, n)
    return torch.from_numpy(v.astype(np.float32).reshape(shape))


@pytest.mark.parametrize("kind", ["random", "tiny", "large", "probabilities",
                                  "mixed"])
def test_split_terms_sum_to_the_operand(kind):
    v = _values(kind, np.random.default_rng(len(kind)))
    terms = _gemm.split3(v)
    assert all(x.dtype == torch.bfloat16 for x in terms)
    assert torch.equal(sum(x.double() for x in terms), v.double())


def test_split_terms_of_subnormal_operands():
    """Below 2^-110 (f32 subnormals included) the last term is a bf16
    subnormal: the split loses at most the bits under 2^-133, far below any
    product the kernel forms."""
    rng = np.random.default_rng(5)
    v = torch.from_numpy(((1 + rng.random(4096)) * 2.0 ** rng.integers(
        -149, -110, 4096)).astype(np.float32))
    assert (v.abs() < 2.0 ** -126).any()                  # f32 subnormals
    err = (sum(x.double() for x in _gemm.split3(v)) - v.double()).abs()
    assert err.max().item() <= 2.0 ** -134


def split3_matmul(a, b):
    """a @ b in the cheaper three-term split: both f32 operands in three
    bf16 terms, the term products with i + j <= 1 only (a1 b1, a2 b0 and
    a0 b2, up to 3 * 2^-18 of |a| |b|, dropped)."""
    at = [x.float() for x in _gemm.split3(a)]
    bt = [x.float() for x in _gemm.split3(b)]
    return at[1] @ bt[0] + at[0] @ bt[1] + at[0] @ bt[0]


@pytest.mark.parametrize("kind", ["random", "probabilities", "mixed",
                                  "tiny", "large"])
def test_split6_product_within_its_bound(kind):
    """The emulated 64-deep products against the exact (float64) product
    and torch's f32 product: within SPLIT_BOUND * sum_k |a_k| |b_k| (where
    the products are normal f32 numbers: tiny and large operands meet
    operands of unit scale).  The three-term split exceeds the bound on
    every kind but the normal-distributed pairs (there its dropped terms
    cancel to 4.3e-6 of the scale)."""
    rng = np.random.default_rng(17 + len(kind))
    a = _values(kind, rng, (6, 64, 64))
    b = _values("random" if kind in ("tiny", "large") else kind, rng,
                (6, 64, 64))
    got = pfa.split6_matmul(a, b)
    scale = a.abs().double() @ b.abs().double()
    exact = a.double() @ b.double()
    assert ((got.double() - exact).abs() <= pfa.SPLIT_BOUND * scale).all()
    f32 = a @ b
    assert ((got.double() - f32.double()).abs() <=
            pfa.SPLIT_BOUND * scale).all()
    # the dropped terms matter: one bf16 term alone is far outside it
    one = a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()
    assert ((one.double() - exact).abs() > pfa.SPLIT_BOUND * scale).any()
    # and the bound tells six terms from three
    if kind != "random":
        three = split3_matmul(a, b)
        assert ((three.double() - exact).abs() >
                pfa.SPLIT_BOUND * scale).any()


class HeadProducts(TorchFunctionMode):
    """Routes the 4-D products ([P, H, T, T'] operands: the per-pair plain
    version's five per-head products, and only those) through a split
    emulation."""

    def __init__(self, matmul):
        super().__init__()
        self.matmul = matmul

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if (getattr(func, "__name__", "") in ("matmul", "__matmul__") and
                args[0].dim() == 4):
            with torch._C.DisableTorchFunction():
                return self.matmul(args[0], args[1])
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("tq,tk,kind", SHAPES)
def test_pair_f32_gate_tells_six_terms_from_three(tq, tk, kind):
    """The per-pair outputs at the flagship's widths (8 heads of 64, 512
    channels) with the per-head products in the kernel's six-term split stay
    within PAIR_F32_REL of the plain version's f32 products; in the
    three-term split some output exceeds it."""
    p = 2
    args, mask, _ = attn_inputs(3 + tq, p, tq, tk, kind, h=8, dk=64, d=512)
    t = [T(a) for a in args]
    m = T(mask)
    oh = pfa.sh_attention_saved_reference(*t, m)[1]
    g = T(np.random.RandomState(1).randn(p, tq, 512).astype(np.float32))
    proj = pfa.project(*t[:5])

    def pairs():
        return pfa.sh_attention_bwd_pairs_reference(*proj, *t[5:8], t[0],
                                                    t[8], m, oh, g)

    want = pairs()
    errs = {}
    for name, matmul in (("six", pfa.split6_matmul), ("three", split3_matmul)):
        with HeadProducts(matmul):
            errs[name] = max(pair_errors(pairs(), want))
    assert errs["six"] <= PAIR_F32_REL < errs["three"], errs


@pytest.mark.parametrize("ta,tb", [(False, False), (True, False),
                                   (False, True), (True, True)])
def test_split_check_plain_version(ta, tb, monkeypatch):
    monkeypatch.setattr(_build, "load", lambda *a, **k: pytest.fail(
        "a CPU tensor built a kernel"))
    rng = np.random.default_rng(2)
    a, b = _values("random", rng, (2, 64, 64)), _values("mixed", rng,
                                                       (2, 64, 64))
    got = pfa.split_check(a, b, ta, tb)
    want = pfa.split6_matmul(a.transpose(1, 2) if ta else a,
                             b.transpose(1, 2) if tb else b)
    assert torch.equal(got, want)


# ------------------------------------------------------- launches, faked


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
        products.append((layout, a, b, kw, out))
        return out

    monkeypatch.setattr(_build, "load", lambda stem, funcs: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(_gemm, "gemm", gemm)
    return lib, products


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["plain", "masks", "save_qkv"])
def test_backward_launches_projections_pairs_products(dtype, mode,
                                                      fake_kernels):
    lib, products = fake_kernels
    p, tq, tk = 3, 7, 5
    args, mask, keep = attn_inputs(1, p, tq, tk, "pad", h=8, dk=64, d=512)
    t = [T(a).to(dtype) for a in args[:8]] + [T(a) for a in args[8:]]
    t.append(T(mask))
    oh = torch.zeros(8, p * tq, 64)
    g = torch.zeros(p, tq, 512, dtype=dtype)
    kdrop, qkv = pfa._NO_DROP, None
    if mode == "masks":
        ak = T(np.ones((8, p * tq, tk), np.float32))
        ok = T(np.ones((p * tq, 512), np.float32))
        kdrop = (None, ak.data_ptr(), ok.data_ptr(), 123, 1.0 / KEEP)
    if mode == "save_qkv":
        qkv = tuple(torch.zeros(8, p * n, 64) for n in (tq, tk, tk))
    grads = pfa._backward(t[0], tuple(t), oh, g, p, tq, tk, "short", kdrop,
                          qkv)
    assert len(grads) == 10
    # the projections first, unless the forward saved q/k/v
    n_proj = 0 if qkv is not None else 3
    proj = [x[4] for x in products[:n_proj]]
    for (layout, a, b, _, res), x, w, rows in zip(
            products[:n_proj], (t[0], t[1], t[1]), t[2:5],
            (p * tq, p * tk, p * tk)):
        assert layout == _gemm.NN
        assert a.data_ptr() == x.data_ptr() and tuple(a.shape) == (rows, 512)
        assert b.data_ptr() == w.data_ptr()
        assert res.dtype == torch.float32 and tuple(res.shape) == (rows, 512)
    # then one per-pair launch on their outputs
    assert [name for name, _ in lib.calls] == ["sh_attention_bwd_pairs"]
    a = lib.calls[0][1]
    assert a[0] == int(dtype == torch.bfloat16)
    assert a[1:9] == tuple(x.data_ptr() for x in
                           (t[0], t[5], t[6], t[7], t[8], t[10], oh, g))
    src = qkv if qkv is not None else proj
    assert a[9:12] == tuple(x.data_ptr() for x in src)
    assert a[12] == int(qkv is not None)
    assert a[22:25] == (p, tq, tk)
    assert a[25:30] == tuple(kdrop)
    dy, dz, dk, dv = a[13], a[19], a[20], a[21]
    assert (a[30] is None) == (mode != "masks")
    dy0 = a[30] if mode == "masks" else dy
    # then the products on the launch's outputs: dxq, dxkv (two), the
    # projections' weight gradients, dsk_w and dfc_w
    rest = products[n_proj:]
    assert [x[0] for x in rest] == [_gemm.NT] * 3 + [_gemm.TN] * 5
    assert rest[0][1].data_ptr() == dz and rest[0][3]["cadd"].data_ptr() == dy
    assert rest[1][1].data_ptr() == dk and rest[2][1].data_ptr() == dv
    assert [x[2].data_ptr() for x in rest[:3]] == [
        w.data_ptr() for w in t[2:5]]
    assert [x[2].data_ptr() for x in rest[3:6]] == [dz, dk, dv]
    assert rest[6][2].data_ptr() == a[16]             # dlogit
    assert rest[6][1].data_ptr() == a[15]             # s
    assert rest[7][2].data_ptr() == dy0
    assert all(x[3].get("out_dtype", torch.float32) == dtype
               for x in rest[3:])


def test_cpu_backward_never_builds_a_kernel(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda *a, **k: pytest.fail(
        "a CPU tensor built a kernel"))
    monkeypatch.setattr(_gemm, "_lib", lambda: pytest.fail(
        "a CPU tensor built csrc/gemm.cu"))
    args, mask, _ = attn_inputs(3, 2, 8, 8, "pad", h=8, dk=64, d=512)
    t = [T(a) for a in args] + [T(mask)]
    before = pfa.fused_sh_attention_bwd.launches
    grads = pfa.fused_sh_attention_bwd(*t, torch.zeros(8, 16, 64),
                                       torch.randn(2, 8, 512))
    assert all(x.device.type == "cpu" for x in grads)
    assert pfa.fused_sh_attention_bwd.launches == before


# ------------------------------------------------------------- on the card


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def pair_errors(got, want):
    """Each per-pair output's max |got - want| over its max |want|."""
    return [((a.float() - b.float()).abs().max() /
             b.float().abs().max().clamp(min=1e-30)).item()
            for a, b in zip(got, want)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["plain", "seed", "masks", "save_qkv"])
@pytest.mark.parametrize("tq,tk", [(56, 56), (64, 64), (64, 48)])
def test_pairs_kernel_matches_plain_version_on_gpu(tq, tk, mode, dtype,
                                                   cuda):
    from ait_tpu_torch.ops import dropout_masks as dm

    p = 40
    args, mask, _ = attn_inputs(5, p, tq, tk, "causal" if tq == tk == 64
                                else "pad", h=8, dk=64, d=512)
    t = [T(a).to(cuda, dtype) for a in args[:8]] + [
        T(a).to(cuda) for a in args[8:]]
    m = T(mask).to(cuda)
    drop, plain = pfa._NO_DROP, {}
    if mode in ("seed", "masks"):
        seed = torch.tensor([7, -8], dtype=torch.int32, device=cuda)
        ak, ok = dm.dropout_keep_masks(seed, p, tq, tk, 512, keep_prob=KEEP)
        plain = dict(attn_keep=ak, out_keep=ok, keep_prob=KEEP)
        drop = (pfa._kernel_drop("bwd", t[0], p, tq, tk, KEEP, seed, None,
                                 None) if mode == "seed" else
                pfa._kernel_drop("bwd", t[0], p, tq, tk, KEEP, None, ak, ok))
    out, oh, *rest = pfa.sh_attention_saved_reference(
        *t, m, save_qkv=mode == "save_qkv", **plain)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(3))
    g = g.to(cuda, dtype)
    # the plain forward's saved q/k/v are strided views; the kernel (as its
    # wrapper requires) reads contiguous ones
    proj = (tuple(x.contiguous() for x in rest[0]) if mode == "save_qkv"
            else pfa.project(*t[:5]))
    got = pfa.short_bwd_pairs(t[0], proj, *t[5:8], t[8], m, oh, g, tk,
                              mode == "save_qkv", drop)
    want = pfa.sh_attention_bwd_pairs_reference(
        *proj, *t[5:8], t[0], t[8], m, oh, g, qkv_saved=mode == "save_qkv",
        **plain)
    torch.cuda.synchronize()
    tol = PAIR_F32_REL if dtype == torch.float32 else PAIR_BF16_REL
    errs = pair_errors(got, want)
    assert max(errs) <= tol, errs


@pytest.mark.gpu
@pytest.mark.parametrize("ta,tb", [(False, False), (True, False),
                                   (False, True), (True, True)])
def test_split_products_within_bound_on_gpu(ta, tb, cuda):
    rng = np.random.default_rng(9)
    a = _values("mixed", rng, (16, 64, 64)).to(cuda)
    b = _values("probabilities", rng, (16, 64, 64)).to(cuda)
    got = pfa.split_check(a, b, ta, tb)
    a2 = (a.transpose(1, 2) if ta else a).double()
    b2 = (b.transpose(1, 2) if tb else b).double()
    err = (got.double() - a2 @ b2).abs()
    assert (err <= pfa.SPLIT_BOUND * (a2.abs() @ b2.abs())).all()


@pytest.mark.gpu
def test_backward_counts_one_launch_per_call_on_gpu(cuda):
    args, mask, _ = attn_inputs(4, 8, 56, 56, "pad", h=8, dk=64, d=512)
    t = [T(a).to(cuda, torch.bfloat16) for a in args[:8]] + [
        T(a).to(cuda) for a in args[8:]]
    m = T(mask).to(cuda)
    out, oh = pfa.fused_sh_attention_saved(*t, m)
    g = torch.ones_like(out)
    before = pfa.fused_sh_attention_bwd.launches
    pfa.fused_sh_attention_bwd(*t, m, oh, g)
    pfa.fused_sh_attention_bwd(*t, m, oh, g)
    torch.cuda.synchronize()
    assert pfa.fused_sh_attention_bwd.launches == before + 2
