"""csrc/gemm.cu's plain side on the CPU: the three-term bf16 split of an f32
operand (`split3`), the plain product `gemm_reference` against float64 for
every layout and epilogue, the three-term product against the JAX package's
own f32 product, and where `gemm` sends a tensor and how it splits K."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ait_tpu_torch.ops import _gemm

LAYOUTS = {"NN": _gemm.NN, "NT": _gemm.NT, "TN": _gemm.TN}


def _f64_sum(*terms):
    return sum(t.double() for t in terms)


def _values(kind, rng):
    if kind == "random":
        v = rng.standard_normal(4096)
    elif kind == "large":
        v = rng.standard_normal(4096) * 2.0 ** rng.integers(60, 126, 4096)
    elif kind == "negative":
        v = -np.abs(rng.standard_normal(4096)) * 2.0 ** rng.integers(-40, 40, 4096)
    elif kind == "zero":
        v = np.zeros(4096)
    else:                          # small, down to where the split stays exact
        v = (1 + rng.random(4096)) * 2.0 ** rng.integers(-110, -90, 4096)
        v[::2] *= -1
    return torch.from_numpy(v.astype(np.float32))


@pytest.mark.parametrize("kind", ["random", "large", "negative", "zero",
                                  "small"])
def test_split3_is_exact(kind):
    v = _values(kind, np.random.default_rng(len(kind)))
    hi, mid, lo = _gemm.split3(v)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(_f64_sum(hi, mid, lo), v.double())
    # hi is v rounded to bf16; each term is at most half an ulp of the last
    assert torch.equal(hi, v.to(torch.bfloat16))
    assert torch.all(mid.double().abs() <= hi.double().abs() * 2.0 ** -8)


def test_split3_below_its_range_and_non_finite():
    """Below 2^-110 lo is a bf16 subnormal: the split loses at most the
    bits under 2^-133.  An infinite v (or one that rounds to bf16 inf) gives
    nan terms; nan stays nan."""
    rng = np.random.default_rng(3)
    v = torch.from_numpy(((1 + rng.random(4096)) * 2.0 ** rng.integers(
        -126, -110, 4096)).astype(np.float32))
    err = (_f64_sum(*_gemm.split3(v)) - v.double()).abs().max().item()
    assert err <= 2.0 ** -134
    special = torch.tensor([float("inf"), -float("inf"), float("nan"),
                            3.4e38])
    hi, mid, lo = _gemm.split3(special)
    assert torch.isinf(hi[:2]).all() and torch.isinf(hi[3])
    assert torch.isnan(_f64_sum(hi, mid, lo)).all()


def _operands(layout, m, n, k, rng, a_dt=torch.float32, b_dt=torch.float32):
    sa = (k, m) if layout == _gemm.TN else (m, k)
    sb = (n, k) if layout == _gemm.NT else (k, n)
    a = torch.from_numpy(rng.standard_normal(sa).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(sb).astype(np.float32))
    return a.to(a_dt), b.to(b_dt)


def _f64_product(layout, a, b):
    a, b = a.double(), b.double()
    if layout == _gemm.TN:
        return a.t() @ b
    return a @ (b.t() if layout == _gemm.NT else b)


EPILOGUES = ["plain", "bias", "cadd_aliases_out", "relu", "mask_f32",
             "mask_bf16", "bf16_out"]


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_gemm_reference_matches_float64(layout, epilogue):
    lay = LAYOUTS[layout]
    rng = np.random.default_rng(7)
    m, n, k = 37, 24, 45
    a, b = _operands(lay, m, n, k, rng, torch.bfloat16, torch.float32)
    want = _f64_product(lay, a, b)
    kw = {}
    if epilogue == "bias":
        kw["bias"] = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
        want = want + kw["bias"].double()
    elif epilogue == "cadd_aliases_out":
        out = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
        want = want + out.double()
        kw.update(cadd=out, out=out)
    elif epilogue == "relu":
        kw["relu"] = True
        want = want.clamp(min=0)
    elif epilogue.startswith("mask"):
        mask = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
        if epilogue == "mask_bf16":
            mask = mask.to(torch.bfloat16)
        kw["mask"] = mask
        want = torch.where(mask.double() > 0, want, 0.0)
    elif epilogue == "bf16_out":
        kw["out_dtype"] = torch.bfloat16
    got = _gemm.gemm_reference(lay, a, b, **kw)
    if "out" in kw:
        assert got is kw["out"]
    scale = want.abs().max().item()
    if epilogue == "bf16_out":
        assert got.dtype == torch.bfloat16
        # one rounding of the f32 result: half a bf16 ulp of the value
        assert ((got.double() - want).abs() <=
                want.abs() * 2.0 ** -8 + 1e-6 * scale).all()
    else:
        assert got.dtype == torch.float32
        assert (got.double() - want).abs().max().item() <= 1e-6 * scale


def _three_terms(layout, a, b):
    """The kernel's arithmetic on the CPU: the f32 operand in three bf16
    terms, three bf16 x bf16 products (exact in f32), summed in f32."""
    if a.dtype == torch.float32:
        return sum(_gemm.gemm_reference(layout, t, b) for t in _gemm.split3(a))
    return sum(_gemm.gemm_reference(layout, a, t) for t in _gemm.split3(b))


@pytest.mark.parametrize("form", ["ffn_weight_grad", "attn_weight_grad",
                                  "attn_input_grad"])
def test_three_term_product_matches_jax(form):
    """pallas_ffn.py:154-161 (dw1 = x^T dy1, x bf16, dy1 f32) and
    pallas_attention.py:608-619 (dwq = xq^T dz; dxq = dz wq^T) at
    precision HIGHEST: within 2e-6 of max |JAX|."""
    rng = np.random.default_rng(len(form))
    rows, d, h = 192, 64, 96
    hi = jax.lax.Precision.HIGHEST
    if form == "ffn_weight_grad":
        x = rng.standard_normal((rows, d)).astype(np.float32)
        dy = (rng.standard_normal((rows, h)) *
              np.exp(rng.standard_normal((rows, h)))).astype(np.float32)
        want = jnp.dot(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32).T,
                       jnp.asarray(dy), preferred_element_type=jnp.float32,
                       precision=hi)
        got = _three_terms(_gemm.TN, torch.from_numpy(x).to(torch.bfloat16),
                           torch.from_numpy(dy))
    elif form == "attn_weight_grad":
        x = rng.standard_normal((rows, d)).astype(np.float32)
        dz = (rng.standard_normal((rows, d)) * 1e-3).astype(np.float32)
        want = jnp.dot(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32).T,
                       jnp.asarray(dz), preferred_element_type=jnp.float32,
                       precision=hi)
        got = _three_terms(_gemm.TN, torch.from_numpy(x).to(torch.bfloat16),
                           torch.from_numpy(dz))
    else:
        dz = (rng.standard_normal((rows, d)) * 1e-3).astype(np.float32)
        w = (rng.standard_normal((h, d)) * d ** -0.5).astype(np.float32)
        want = jnp.dot(jnp.asarray(dz),
                       jnp.asarray(w).astype(jnp.bfloat16).astype(jnp.float32).T,
                       preferred_element_type=jnp.float32, precision=hi)
        got = _three_terms(_gemm.NT, torch.from_numpy(dz),
                           torch.from_numpy(w).to(torch.bfloat16))
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = np.abs(got.numpy() - want).max()
    assert err <= 2e-6 * np.abs(want).max(), err


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_cpu_tensors_take_the_plain_version(layout, monkeypatch):
    lay = LAYOUTS[layout]
    calls = []
    real = _gemm.gemm_reference
    monkeypatch.setattr(_gemm, "gemm_reference",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(_gemm, "_lib", lambda: pytest.fail("built a kernel"))
    before = (_gemm.gemm.launches, _gemm.gemm.fma_launches)
    a, b = _operands(lay, 9, 16, 11, np.random.default_rng(0),
                     torch.bfloat16, torch.float32)
    out = _gemm.gemm(lay, a, b, out_dtype=torch.bfloat16)
    assert calls == [1] and out.dtype == torch.bfloat16
    assert torch.equal(out, real(lay, a, b, out_dtype=torch.bfloat16))
    assert (_gemm.gemm.launches, _gemm.gemm.fma_launches) == before


@pytest.mark.parametrize("devices", [("meta", "meta"), ("cpu", "meta")])
def test_tensors_off_the_cpu_never_take_the_plain_version(devices,
                                                          monkeypatch):
    monkeypatch.setattr(_gemm, "gemm_reference", lambda *a, **k: pytest.fail(
        "the plain version ran for a tensor off the CPU"))
    a = torch.empty(8, 16, dtype=torch.bfloat16, device=devices[0])
    b = torch.empty(16, 8, dtype=torch.float32, device=devices[1])
    before = (_gemm.gemm.launches, _gemm.gemm.fma_launches)
    with pytest.raises(ValueError, match="CUDA"):
        _gemm.gemm(_gemm.NN, a, b)
    assert (_gemm.gemm.launches, _gemm.gemm.fma_launches) == before


def test_tensor_cores_take_any_bf16_operand():
    bf, f32 = torch.bfloat16, torch.float32
    t = {dt: torch.empty(1, dtype=dt) for dt in (bf, f32)}
    assert _gemm.tensor_core_path(t[bf], t[bf])
    assert _gemm.tensor_core_path(t[bf], t[f32])
    assert _gemm.tensor_core_path(t[f32], t[bf])
    assert not _gemm.tensor_core_path(t[f32], t[f32])


# (M, N, K) of the default train step's products at B = 8, and the splits
# the 132 SMs of an H100 get: the weight gradients split K, nothing else
TRAIN_SHAPES = {
    "ffn dw1 (encoder)": ((512, 2048, 57344), 2),
    "ffn dw2 (decoder)": ((2048, 512, 65536), 2),
    "ffn y1 (decoder)": ((65536, 2048, 512), 1),
    "ffn dx (encoder)": ((57344, 512, 2048), 1),
    "attention dwq (encoder)": ((512, 512, 57344), 8),
    "attention dfc_w (cross)": ((64, 512, 65536), 30),
    "attention dwq (decoder self)": ((512, 512, 512), 1),
    "long-seq projection": ((15200, 512, 512), 1),
}


@pytest.mark.parametrize("name", sorted(TRAIN_SHAPES))
def test_tc_splits_fill_the_card(name):
    (m, n, k), want = TRAIN_SHAPES[name]
    s = _gemm.tc_splits(m, n, k, 132)
    assert s == want
    assert -(-k // 64) >= 8 * s or s == 1
    blocks = -(-m // 128) * -(-n // 128) * s
    if s > 1:
        assert blocks / (-(-blocks // 132) * 132) >= 0.9


def test_plain_ffn_takes_another_evaluations_relu_mask():
    """The plain FFN backward fed its own relu mask is the plain FFN
    backward; fed a mask with one element flipped, only that element's row
    of dx changes, and db1 moves in that element's column.  chip_smoke.py
    feeds it the tensor-core recompute's mask, whose ties at 0 the f32
    summation order decides."""
    from ait_tpu_torch.ops import fused_ffn as ff

    rng = np.random.default_rng(11)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32))

    d, h, n = 16, 24, 10
    args = [t(n, d), t(d, h, scale=d ** -0.5), t(h, scale=0.05),
            t(h, d, scale=h ** -0.5), t(d, scale=0.05), 1 + t(d, scale=0.1),
            t(d, scale=0.1), t(n, d)]
    pre = args[0] @ args[1] + args[2]
    base = ff.ffn_bwd_reference(*args)
    same = ff.ffn_bwd_reference(*args, relu_mask=pre > 0)
    assert all(torch.equal(a, b) for a, b in zip(base, same))
    r, j = (pre > 0).nonzero()[0].tolist()
    mask = pre > 0
    mask[r, j] = False
    dx, _, db1 = ff.ffn_bwd_reference(*args, relu_mask=mask)[:3]
    rows = ((dx - base[0]).abs() > 0).any(dim=1)
    assert rows[r] and rows.sum() == 1
    assert db1[j] != base[2][j]
