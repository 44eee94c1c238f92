"""The kernel wrappers' dispatch: a CPU tensor takes the plain version, a
tensor off the CPU goes to the kernel or raises, never to the plain version.

The `gpu` tests hold each CUDA kernel against its plain version on the card
at small valid shapes (chip_smoke.py does the same at the flagship's).  This
file imports nothing of JAX, so on a machine with a GPU and no JAX they run
with

    python -m pytest --noconftest -m gpu tests/test_torch_port_dispatch.py
"""

import importlib
import pytest
import torch

from ait_tpu_torch.ops import fused_attention as pfa
from ait_tpu_torch.ops import fused_ffn as pff

# the module (ait_tpu_torch.ops exports its `nms` function under that name)
pnms = importlib.import_module("ait_tpu_torch.ops.nms")


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


# ROI Align: `roi_align` takes the plain version for a CPU tensor or a call
# that needs a gradient and the kernel for every other call, and counts the
# rois of each route
pra = importlib.import_module("ait_tpu_torch.ops.roi_align")


def _roi_operands(device, dtype=torch.bfloat16, c=16, grad=False):
    """feat [2, 6, 9, c] and rois [2, 5, 4] in image coords (stride 16),
    one of them degenerate (x2 < x1)."""
    g = torch.Generator().manual_seed(1)
    feat = torch.randn(2, 6, 9, c, generator=g).to(device, dtype)
    xy = torch.rand(2, 5, 2, generator=g) * torch.tensor([9 * 16., 6 * 16.])
    wh = torch.rand(2, 5, 2, generator=g) * 80 + 1
    rois = torch.cat([xy, xy + wh], -1)
    rois[1, 2, 2] = rois[1, 2, 0] - 5.0
    return feat.requires_grad_(grad), rois.to(device)


def _fake_kernel(routes):
    def run(feat, rois, *, out_size=7, **kw):
        routes.append("kernel")
        return feat.new_empty(rois.shape[:2] + (out_size, out_size,
                                                feat.shape[-1]))
    return run


@pytest.mark.parametrize("ratio", [0, 2])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_roi_align_cpu_tensor_takes_plain_version(dtype, ratio, monkeypatch):
    """A CPU map goes to the plain version, bit for bit, never the kernel."""
    monkeypatch.setattr(pra, "roi_align_cuda", lambda *a, **k: pytest.fail(
        "the kernel ran for a CPU tensor"))
    feat, rois = _roi_operands("cpu", dtype)
    got = pra.roi_align(feat, rois, sampling_ratio=ratio)
    want = pra.roi_align_reference(feat, rois, sampling_ratio=ratio)
    assert got.dtype == dtype and torch.equal(got, want)


ROI_ROUTES = {
    # (grad mode, map requires grad, dtype, channels) -> route
    "serving": ((False, False, torch.bfloat16, 16), "kernel"),
    "serving_f32": ((False, False, torch.float32, 16), "kernel"),
    "train_forward": ((True, True, torch.bfloat16, 16), "plain"),
    "no_grad_on_a_grad_map": ((False, True, torch.bfloat16, 16), "kernel"),
    "grad_mode_frozen_map": ((True, False, torch.bfloat16, 16), "kernel"),
    "f16": ((False, False, torch.float16, 16), "kernel"),
    "channels_not_in_8s": ((False, False, torch.bfloat16, 12), "kernel")}


@pytest.mark.parametrize("case", sorted(ROI_ROUTES))
def test_roi_align_route_and_counters_off_cpu(case, monkeypatch):
    """Meta tensors (no GPU here, and no data: a sync or a data-dependent
    count would raise) through `roi_align` inside a recording: the route
    the call takes, and the one counter it adds, B x R rois."""
    from ait_tpu_torch.utils.profiling import recording

    (grad_mode, grad, dtype, c), route = ROI_ROUTES[case]
    routes = []
    monkeypatch.setattr(pra, "roi_align_cuda", _fake_kernel(routes))
    real = pra.roi_align_reference
    monkeypatch.setattr(pra, "roi_align_reference", lambda *a, **k: (
        routes.append("plain"), real(*a, **k))[1])
    feat, rois = _roi_operands("meta", dtype, c, grad)
    with recording() as rec, torch.set_grad_enabled(grad_mode):
        out = pra.roi_align(feat, rois)
    assert routes == [route]
    assert out.shape == (2, 5, 7, 7, c) and out.dtype == dtype
    assert rec.counts == {f"roi_align.{route}_rois": 10}


@pytest.mark.parametrize("dtype,c,msg", [
    (torch.float16, 16, "bf16 or f32"),
    (torch.bfloat16, 12, "groups of 8")], ids=["f16", "channels_not_in_8s"])
def test_roi_align_kernel_wrapper_refuses_a_map_it_cannot_read(dtype, c, msg):
    """A map off the CPU that the kernel cannot read raises through the
    kernel's wrapper, before any launch, instead of falling back to the
    plain version."""
    before = pra.roi_align_cuda.launches
    feat, rois = _roi_operands("meta", dtype, c)
    with torch.inference_mode(), pytest.raises(ValueError, match=msg):
        pra.roi_align(feat, rois)
    assert pra.roi_align_cuda.launches == before


def test_roi_align_kernel_wrapper_refuses_a_map_off_cuda():
    """The kernel's wrapper raises for a tensor that is not on a CUDA
    device, before any launch."""
    before = pra.roi_align_cuda.launches
    feat, rois = _roi_operands("meta")
    with pytest.raises(ValueError, match="CUDA"):
        pra.roi_align(feat, rois)
    assert pra.roi_align_cuda.launches == before
