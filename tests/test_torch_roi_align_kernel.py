"""csrc/roi_align.cu on the card against the plain version computed in f32.

The kernel computes every sample position, tap and fraction as the plain
version does, keeps the weights and sums in f32 and rounds once, at the
store.  So in bf16 it must lie within one bf16 rounding of the f32 value
(half an ulp, 2^-8 of |value|, beyond the f32 sums' own ~1e-6 error, held
here to 2^-14 of the sum of |terms|), and no farther from it than the bf16
plain version, which also rounds its weights and its [R, 7, H, C]
intermediate.  The maps are the serving cells' (38 x 50 and 50 x 68 at
1024 channels); the rois are proposal-like boxes plus the edge cases: rois
crossing the -1 and H edges, entirely outside the map, degenerate
(x2 < x1), zero, and the full map (the adaptive grid at its cap).

The f32 reference is computed on the CPU: on a CUDA tensor PyTorch divides
by a Python number as a product with its f32 reciprocal, so the plain
version's bin, roi_extent / 7, can differ by an ulp there, and with it a
sample's taps; the kernel divides as the CPU, the JAX package and the
reference CUDA kernel do.

The tests skip without a GPU.  This file imports nothing of JAX; on a
machine with a GPU:

    python -m pytest --noconftest -m gpu tests/test_torch_roi_align_kernel.py
"""

import pytest
import torch

from ait_tpu_torch.ops import roi_align as pra
from ait_tpu_torch.utils.profiling import recording

MAPS = {"res50": (38, 50), "res101ls": (50, 68)}
STRIDE, C, B = 16, 1024, 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _rois(hh, ww, n, seed):
    """[B, n + 8, 4]: n boxes with centres over the image and sides of
    16 px to the whole image, then the edge cases."""
    g = torch.Generator().manual_seed(seed)
    img = torch.tensor([ww * STRIDE, hh * STRIDE], dtype=torch.float32)
    ctr = torch.rand(B, n, 2, generator=g) * img
    wh = 16 + torch.rand(B, n, 2, generator=g) * (img - 16)
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], -1)
    boxes = torch.minimum(boxes.clamp(min=0), (img - 1).repeat(2))
    w, h = float(img[0]), float(img[1])
    edges = torch.tensor([
        [-40.0, -30.0, 120.0, 90.0],          # crosses the -1 edges
        [w - 100.0, h - 60.0, w + 50.0, h + 40.0],   # crosses the H, W edges
        [-300.0, -200.0, -100.0, -60.0],      # entirely before -1
        [w + 40.0, h + 40.0, w + 400.0, h + 300.0],  # entirely past H, W
        [200.0, 100.0, 150.0, 60.0],          # degenerate: x2 < x1, y2 < y1
        [0.0, 0.0, 0.0, 0.0],                 # a zero (padding) roi
        [0.0, 0.0, w - 1.0, h - 1.0],         # the full map: grid at its cap
        [17.3, 33.9, 17.4, 300.2]])           # thinner than a pixel
    return torch.cat([boxes, edges[None].expand(B, -1, -1)], 1)


def _reference(feat, rois, ratio=0):
    """The plain version in f32 on the CPU, of feat and of |feat| (the sum
    of |terms|, which bounds the f32 sums' error), back on feat's device."""
    f32, r = feat.float().cpu(), rois.cpu()
    return tuple(pra.roi_align_reference(f, r, sampling_ratio=ratio).to(
        feat.device) for f in (f32, f32.abs()))


def _inputs(dev, hh, ww, seed, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    feat = torch.randn(B, hh, ww, C, generator=g).to(dev, dtype)
    return feat, _rois(hh, ww, 120, seed).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("ratio", [0, 2])
@pytest.mark.parametrize("shape", sorted(MAPS))
def test_kernel_within_one_bf16_rounding_of_f32(shape, ratio, cuda):
    feat, rois = _inputs(cuda, *MAPS[shape], seed=3 + ratio)
    before = pra.roi_align_cuda.launches
    with torch.inference_mode():
        got = pra.roi_align(feat, rois, sampling_ratio=ratio)
        assert pra.roi_align_cuda.launches == before + 1
        ref, mag = _reference(feat, rois, ratio)
        plain = pra.roi_align_reference(feat, rois, sampling_ratio=ratio)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    err = (got.float() - ref).abs()
    tol = 2.0 ** -8 * ref.abs() + 2.0 ** -14 * mag
    assert bool((err <= tol).all()), float((err - tol).max())
    plain_err = (plain.float() - ref).abs()
    assert float(err.max()) <= float(plain_err.max())
    assert float(err.mean()) <= float(plain_err.mean())
    # the rois wholly outside the map read exactly zero
    assert not bool(got[:, -6:-4].any())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(MAPS))
def test_kernel_f32_map(shape, cuda):
    """COCO's co-attention hands ROI Align an f32 map: the kernel reads and
    writes f32, within the f32 sums' error of the plain version."""
    feat, rois = _inputs(cuda, *MAPS[shape], seed=11, dtype=torch.float32)
    with torch.inference_mode():
        got = pra.roi_align(feat, rois)
        ref, mag = _reference(feat, rois)
    assert got.dtype == torch.float32
    assert bool(((got - ref).abs() <= 2.0 ** -14 * mag).all())


@pytest.mark.gpu
def test_kernel_is_deterministic_and_counts_without_syncs(cuda):
    """Two calls give the same bits; inside a recording (torch's sync
    debug mode on) the call counts its rois and no host sync."""
    feat, rois = _inputs(cuda, *MAPS["res50"], seed=5)
    sliced = torch.cat([rois.new_zeros(rois.shape[:2] + (1,)), rois], -1)
    with torch.inference_mode():
        first = pra.roi_align(feat, rois)
        with recording() as rec:
            again = pra.roi_align(feat, sliced[..., 1:5])
        torch.cuda.synchronize()
    assert torch.equal(first, again)
    assert rec.counts == {"roi_align.kernel_rois": rois.shape[0] *
                          rois.shape[1]}


@pytest.mark.gpu
def test_training_forward_takes_plain_version_and_its_gradient(cuda):
    """A map that requires grad under grad mode goes to the plain version:
    no launch, and the gradient flows through its einsums."""
    feat, rois = _inputs(cuda, *MAPS["res50"], seed=7)
    feat.requires_grad_(True)
    before = pra.roi_align_cuda.launches
    out = pra.roi_align(feat, rois)
    out.float().sum().backward()
    assert pra.roi_align_cuda.launches == before
    want = feat.detach().clone().requires_grad_(True)
    pra.roi_align_reference(want, rois).float().sum().backward()
    assert torch.equal(feat.grad, want.grad)
