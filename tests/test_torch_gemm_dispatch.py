"""csrc/gemm.cu on the card: every layout and operand-type pair against its
plain version `gemm_reference` at ragged sizes, the epilogues, split-K
determinism, the launch counts of the two paths, and what the wrapper
refuses.  A CPU tensor takes the plain version (checked here too).

This file imports nothing of JAX, so on a machine with a GPU and no JAX the
card tests run with

    python -m pytest --noconftest -m gpu tests/test_torch_gemm_dispatch.py
"""

import pytest
import torch

from ait_tpu_torch.ops import _gemm

LAYOUTS = {"NN": _gemm.NN, "NT": _gemm.NT, "TN": _gemm.TN}
TYPES = {"bf16xbf16": (torch.bfloat16, torch.bfloat16),
         "bf16xf32": (torch.bfloat16, torch.float32),
         "f32xbf16": (torch.float32, torch.bfloat16),
         "f32xf32": (torch.float32, torch.float32)}


def _operands(layout, m, n, k, a_dt, b_dt, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    sa = (k, m) if layout == _gemm.TN else (m, k)
    sb = (n, k) if layout == _gemm.NT else (k, n)
    return (torch.randn(*sa, generator=g).to(device, a_dt),
            torch.randn(*sb, generator=g).to(device, b_dt))


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max() /
            want.float().abs().max().clamp(min=1e-30)).item()


def test_cpu_tensor_takes_plain_version(monkeypatch):
    monkeypatch.setattr(_gemm, "_lib", lambda: pytest.fail("built a kernel"))
    a, b = _operands(_gemm.TN, 20, 24, 33, torch.bfloat16, torch.float32,
                     "cpu")
    got = _gemm.gemm(_gemm.TN, a, b, out_dtype=torch.bfloat16)
    assert torch.equal(got, _gemm.gemm_reference(
        _gemm.TN, a, b, out_dtype=torch.bfloat16))


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("types", sorted(TYPES))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_kernel_matches_plain_version_on_gpu(layout, types, cuda):
    """Ragged M and K (not multiples of the 128 x 128 x 64 tiles), N a
    multiple of 8: f32 outputs within 1e-4 of max |plain| (f32 summation
    order; the f32 operand's three bf16 terms are exact).  A bf16 operand
    counts a tensor-core launch, f32 x f32 an FMA-tile launch."""
    lay = LAYOUTS[layout]
    a, b = _operands(lay, 200, 136, 1000, *TYPES[types], cuda)
    before = (_gemm.gemm.launches, _gemm.gemm.fma_launches)
    got = _gemm.gemm(lay, a, b)
    torch.cuda.synchronize()
    tc = types != "f32xf32"
    assert (_gemm.gemm.launches, _gemm.gemm.fma_launches) == (
        before[0] + tc, before[1] + (not tc))
    assert _rel_err(got, _gemm.gemm_reference(lay, a, b)) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("epilogue", ["bias_relu_bf16", "mask_bf16",
                                      "mask_f32", "cadd_aliases_out"])
def test_epilogues_on_gpu(epilogue, cuda):
    """The FFN's and the attention's epilogues on the tensor cores: f32
    within 1e-4 of max |plain|, bf16 within 8e-3 (a rounding apart)."""
    g = torch.Generator().manual_seed(1)
    m, n, k = 300, 256, 520
    layout = _gemm.NN if epilogue == "bias_relu_bf16" else _gemm.NT
    a_dt = torch.float32 if epilogue == "cadd_aliases_out" else torch.bfloat16
    a, b = _operands(layout, m, n, k, a_dt, torch.bfloat16, cuda, seed=2)
    kw = {}
    if epilogue == "bias_relu_bf16":
        kw = dict(bias=torch.randn(n, generator=g).to(cuda), relu=True,
                  out_dtype=torch.bfloat16)
    elif epilogue.startswith("mask"):
        mask = torch.randn(m, n, generator=g).to(cuda)
        kw["mask"] = mask.bfloat16() if epilogue == "mask_bf16" else mask
    want = _gemm.gemm_reference(layout, a, b, **kw)
    if epilogue == "cadd_aliases_out":
        out = torch.randn(m, n, generator=g).to(cuda)
        want = _gemm.gemm_reference(layout, a, b, cadd=out.clone())
        kw.update(cadd=out, out=out)
    got = _gemm.gemm(layout, a, b, **kw)
    torch.cuda.synchronize()
    if "out" in kw:
        assert got is kw["out"]
    assert got.dtype == want.dtype
    tol = 8e-3 if got.dtype == torch.bfloat16 else 1e-4
    assert _rel_err(got, want) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("types", ["bf16xf32", "f32xf32"])
def test_split_k_is_deterministic(types, cuda):
    """A weight gradient's split K: two runs bit-equal (partials summed in
    split order, no atomics), and within 1e-4 of max |plain|."""
    a, b = _operands(_gemm.TN, 512, 512, 16384, *TYPES[types], cuda)
    assert _gemm.tc_splits(512, 512, 16384, torch.cuda.get_device_properties(
        cuda).multi_processor_count) > 1
    r1 = _gemm.gemm(_gemm.TN, a, b)
    r2 = _gemm.gemm(_gemm.TN, a, b)
    torch.cuda.synchronize()
    assert torch.equal(r1, r2)
    assert _rel_err(r1, _gemm.gemm_reference(_gemm.TN, a, b)) <= 1e-4


@pytest.mark.gpu
def test_kernel_refuses_other_dtypes_and_unaligned_rows(cuda):
    """A CUDA operand of another dtype, or a tensor-core operand whose rows
    are not 16-byte multiples, raises before any launch."""
    before = (_gemm.gemm.launches, _gemm.gemm.fma_launches)
    a, b = _operands(_gemm.NN, 64, 64, 64, torch.float16, torch.bfloat16,
                     cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        _gemm.gemm(_gemm.NN, a, b)
    a, b = _operands(_gemm.NN, 64, 64, 60, torch.bfloat16, torch.bfloat16,
                     cuda)
    with pytest.raises(ValueError, match="16 bytes"):
        _gemm.gemm(_gemm.NN, a, b)
    a, b = _operands(_gemm.NN, 64, 64, 64, torch.bfloat16, torch.bfloat16,
                     cuda)
    with pytest.raises(ValueError, match="CUDA"):
        _gemm.gemm(_gemm.NN, a, b.cpu())
    assert (_gemm.gemm.launches, _gemm.gemm.fma_launches) == before
