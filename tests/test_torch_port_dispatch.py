"""The kernel wrappers' dispatch: a CPU tensor takes the plain version, a
tensor off the CPU goes to the kernel or raises, never to the plain version.

The `gpu` tests hold each CUDA kernel against its plain version on the card
at small valid shapes (chip_smoke.py does the same at the flagship's).  This
file imports nothing of JAX, so on a machine with a GPU and no JAX they run
with

    python -m pytest --noconftest -m gpu tests/test_torch_port_dispatch.py
"""

import pytest
import torch

from ait_tpu_torch.ops import fused_attention as pfa
from ait_tpu_torch.ops import fused_ffn as pff
from ait_tpu_torch.ops import nms as pnms


def _small_calls(device):
    """One call of each wrapper on tensors on `device`, valid kernel shapes."""
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g).to(device)

    d, h, dk = 512, 8, 64
    mask = torch.ones(8, 8, dtype=torch.bool, device=device)
    boxes = torch.rand(1, 300, 4, generator=g).to(device) * 100
    boxes[..., 2:] += boxes[..., :2]
    return {
        "nms": lambda: pnms.nms_keep_mask_batched(
            boxes, torch.ones(1, 300, dtype=torch.bool, device=device), 0.5,
            max_out=50),
        "attention": lambda: pfa.fused_sh_attention(
            r(2, 8, d), r(2, 8, d), r(d, d), r(d, d), r(d, d),
            r(dk, h * dk), r(h * dk), r(dk, d), r(d), r(d), mask),
        "ffn": lambda: pff.fused_ffn(r(16, d), r(d, 2048), r(2048),
                                     r(2048, d), r(d), r(d), r(d)),
        "posln": lambda: pff.fused_posln(r(16, d), r(8, d), r(d), r(d)),
    }


WRAPPERS = {"nms": (pnms, "nms_keep_mask_batched", "nms_keep_mask_reference"),
            "attention": (pfa, "fused_sh_attention", "sh_attention_reference"),
            "ffn": (pff, "fused_ffn", "ffn_reference"),
            "posln": (pff, "fused_posln", "posln_reference")}


@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_cpu_tensor_takes_plain_version(kernel, monkeypatch):
    mod, wrapper, plain = WRAPPERS[kernel]
    calls = []
    real = getattr(mod, plain)
    monkeypatch.setattr(mod, plain,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    before = getattr(mod, wrapper).launches
    out = _small_calls("cpu")[kernel]()
    assert calls == [1] and out.device.type == "cpu"
    assert getattr(mod, wrapper).launches == before


@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_non_cpu_tensor_never_takes_plain_version(kernel, monkeypatch):
    """A tensor off the CPU goes to the kernel or raises; here (meta
    tensors, no GPU) it raises before any launch."""
    mod, wrapper, plain = WRAPPERS[kernel]
    monkeypatch.setattr(mod, plain, lambda *a, **k: pytest.fail(
        "the plain version ran for a tensor off the CPU"))
    before = getattr(mod, wrapper).launches
    with pytest.raises(ValueError, match="CUDA"):
        _small_calls("meta")[kernel]()
    assert getattr(mod, wrapper).launches == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_kernel_matches_plain_version_on_gpu(kernel, cuda, monkeypatch):
    """The same seeded inputs through the kernel, then (wrapper swapped for
    its plain version) through the plain version; f32 with TF32 off."""
    mod, wrapper, plain = WRAPPERS[kernel]
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    before = getattr(mod, wrapper).launches
    got = _small_calls(cuda)[kernel]()
    assert getattr(mod, wrapper).launches == before + 1
    monkeypatch.setattr(mod, wrapper, getattr(mod, plain))
    want = _small_calls(cuda)[kernel]()
    if kernel == "nms":
        sel_got, n_got = pnms._select_top(got, 50)
        sel_want, n_want = pnms._select_top(want, 50)
        assert torch.equal(n_got, n_want)
        assert torch.equal(sel_got[0, :int(n_got[0])],
                           sel_want[0, :int(n_want[0])])
    else:
        torch.testing.assert_close(got, want, rtol=0.0, atol=2e-3)
