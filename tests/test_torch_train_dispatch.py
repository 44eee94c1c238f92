"""The train path's kernel wrappers: a CPU tensor takes the plain version,
a tensor off the CPU goes to the kernel or raises, and on the card each
kernel matches its plain version and refuses what it does not take.

This file imports nothing of JAX, so on a machine with a GPU and no JAX the
card tests run with

    python -m pytest --noconftest -m gpu tests/test_torch_train_dispatch.py
"""

import pytest
import torch

from ait_tpu_torch.ops import fused_attention as pfa
from ait_tpu_torch.ops import fused_ffn as pff

D, H, DK, HID = 512, 8, 64, 2048


def _operands(device, dtype=torch.float32, p=3, tq=8, tk=8, n=72, t=8):
    """Valid operands of each new wrapper at small shapes."""
    g = torch.Generator().manual_seed(0)

    def r(*shape, scale=1.0, dt=dtype):
        return (torch.randn(*shape, generator=g) * scale).to(device, dt)

    xq = r(p, tq, D)
    xkv = r(p, tk, D)
    attn = [xq, xkv, r(D, D, scale=D ** -0.5), r(D, D, scale=D ** -0.5),
            r(D, D, scale=D ** -0.5), r(DK, H * DK, scale=DK ** -0.5),
            r(H * DK, scale=0.05), r(DK, D, scale=DK ** -0.5),
            1 + r(D, scale=0.1, dt=torch.float32),
            r(D, scale=0.1, dt=torch.float32),
            torch.tril(torch.ones(tq, tk, dtype=torch.bool)).to(device)]
    oh = r(H, p * tq, DK, dt=torch.float32)
    ffn = [r(n, D), r(D, HID, scale=D ** -0.5),
           r(HID, scale=0.05, dt=torch.float32), r(HID, D, scale=HID ** -0.5),
           r(D, scale=0.05, dt=torch.float32),
           1 + r(D, scale=0.1, dt=torch.float32),
           r(D, scale=0.1, dt=torch.float32)]
    posln = [r(n, D), r(t, D), 1 + r(D, scale=0.1, dt=torch.float32),
             r(D, scale=0.1, dt=torch.float32)]
    return dict(attn=attn, oh=oh, g_attn=r(p, tq, D), ffn=ffn,
                g_rows=r(n, D), posln=posln)


def _calls(ops):
    """kernel name -> a call of its wrapper on `ops`."""
    return {
        "attention_saved": lambda: pfa.fused_sh_attention_saved(*ops["attn"]),
        "attention_bwd": lambda: pfa.fused_sh_attention_bwd(
            *ops["attn"], ops["oh"], ops["g_attn"]),
        "ffn_bwd": lambda: pff.fused_ffn_bwd(*ops["ffn"], ops["g_rows"]),
        "posln_bwd": lambda: pff.fused_posln_bwd(*ops["posln"],
                                                 ops["g_rows"]),
    }


WRAPPERS = {
    "attention_saved": (pfa, "fused_sh_attention_saved",
                        "sh_attention_saved_reference"),
    "attention_bwd": (pfa, "fused_sh_attention_bwd",
                      "sh_attention_bwd_reference"),
    "ffn_bwd": (pff, "fused_ffn_bwd", "ffn_bwd_reference"),
    "posln_bwd": (pff, "fused_posln_bwd", "posln_bwd_reference"),
}


@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_cpu_tensor_takes_plain_version(kernel, monkeypatch):
    mod, wrapper, plain = WRAPPERS[kernel]
    calls = []
    real = getattr(mod, plain)
    monkeypatch.setattr(mod, plain,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    before = getattr(mod, wrapper).launches
    out = _calls(_operands("cpu"))[kernel]()
    assert calls == [1]
    assert all(t.device.type == "cpu" for t in out)
    assert getattr(mod, wrapper).launches == before


@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_non_cpu_tensor_never_takes_plain_version(kernel, monkeypatch):
    """Meta tensors (no GPU here): the wrapper raises before any launch."""
    mod, wrapper, plain = WRAPPERS[kernel]
    monkeypatch.setattr(mod, plain, lambda *a, **k: pytest.fail(
        "the plain version ran for a tensor off the CPU"))
    before = getattr(mod, wrapper).launches
    with pytest.raises(ValueError, match="CUDA"):
        _calls(_operands("meta"))[kernel]()
    assert getattr(mod, wrapper).launches == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max() /
            want.float().abs().max().clamp(min=1e-30)).item()


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_kernel_matches_plain_version_on_gpu(kernel, cuda, monkeypatch):
    """float32, TF32 off: every output within 5e-3 of its max |plain|
    (the backward gate of tools/tpu_kernel_check.py); the saved per-head
    outputs within 2e-3 absolute."""
    mod, wrapper, plain = WRAPPERS[kernel]
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    ops = _operands(cuda)
    if kernel == "attention_bwd":      # the oh that this forward saves
        ops["oh"] = pfa.fused_sh_attention_saved(*ops["attn"])[1]
    before = getattr(mod, wrapper).launches
    got = _calls(ops)[kernel]()
    torch.cuda.synchronize()
    assert getattr(mod, wrapper).launches == before + 1
    monkeypatch.setattr(mod, wrapper, getattr(mod, plain))
    want = _calls(ops)[kernel]()
    for i, (a, b) in enumerate(zip(got, want)):
        if kernel == "attention_saved":
            assert (a - b).abs().max().item() <= 2e-3, i
        else:
            assert _rel_err(a, b) <= 5e-3, i


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_kernel_refuses_shapes_and_device_mix(kernel, cuda):
    """A shape the kernel does not take, or an operand left on the CPU,
    raises before any launch."""
    mod, wrapper, _ = WRAPPERS[kernel]
    before = getattr(mod, wrapper).launches
    bad_shape = _operands(cuda)
    if kernel.startswith("attention"):
        bad_shape["attn"][0] = bad_shape["attn"][0][..., :256].contiguous()
    elif kernel == "ffn_bwd":
        bad_shape["ffn"][1] = bad_shape["ffn"][1][:, :1024].contiguous()
    else:
        bad_shape["posln"][1] = bad_shape["posln"][1][:5].contiguous()
    with pytest.raises(ValueError):
        _calls(bad_shape)[kernel]()
    mixed = _operands(cuda)
    key = {"attention_saved": "attn", "attention_bwd": "attn",
           "ffn_bwd": "ffn", "posln_bwd": "posln"}[kernel]
    mixed[key][2] = mixed[key][2].cpu()
    with pytest.raises(ValueError):
        _calls(mixed)[kernel]()
    assert getattr(mod, wrapper).launches == before
