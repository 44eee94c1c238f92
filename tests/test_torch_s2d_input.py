"""The 12-channel space-to-depth input (`tpu.host_s2d`, the default) in the
port: the device-side normalize over 12 channels, the ResNet stem's 4x4
convolution over 12 planes, and the whole eval forward on a batch from the
port's loader, against the port's own 3-channel path and against ait_tpu
on the same input (tiny flagship, float32, CPU).

Tolerances (float32; the two stems sum the same 147 products in another
order): the stem's features within 1e-5 of their max, the backbone's
within 1e-5 of their max (measured ~2e-6); the detector's outputs as
tests/test_torch_port_slice.py holds them: rois 1e-2 px, cls_prob 1e-5,
bbox_pred 1e-4.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_port_harness as harness
from ait_tpu.models.detector import _to_model_input as jax_input
from ait_tpu_torch.config import Config
from ait_tpu_torch.data import OneShotLoader
from ait_tpu_torch.data.transforms import space_to_depth
from ait_tpu_torch.data.voc import filter_seen, load_voc
from ait_tpu_torch.models.detector import _to_model_input
from ait_tpu_torch.models.resnet import ResNetBackbone, s2d_stem_weight

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from fixtures import make_voc_devkit  # noqa: E402


def T(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def test_normalize_tiles_over_12_channels():
    rng = np.random.RandomState(0)
    x = rng.randint(0, 256, (2, 6, 8, 3)).astype(np.uint8)
    x12 = space_to_depth(x)
    got = _to_model_input(T(x12), torch.float32).numpy()
    np.testing.assert_array_equal(
        got, space_to_depth(_to_model_input(T(x), torch.float32).numpy()))
    np.testing.assert_allclose(got, np.asarray(
        jax_input(jnp.asarray(x12), jnp.float32)), rtol=0, atol=1e-6)


def test_stem_weight_regroup():
    """The 4x4 kernel over 12 planes is the 7x7/2 kernel: on any input the
    two convolutions agree (float64, so only the regroup is tested)."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(64, 3, 7, 7, generator=g, dtype=torch.float64)
    x = torch.randn(2, 3, 20, 28, generator=g, dtype=torch.float64)
    want = F.conv2d(x, w, stride=2, padding=3)
    x12 = torch.from_numpy(space_to_depth(
        x.permute(0, 2, 3, 1).numpy())).permute(0, 3, 1, 2)
    got = F.conv2d(F.pad(x12, (2, 1, 2, 1)), s2d_stem_weight(w))
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


def test_backbone_s2d_matches_3_channels():
    torch.manual_seed(0)
    m = ResNetBackbone()
    for p in m.parameters():
        p.data.normal_(0, 0.05)
    x = np.random.RandomState(1).randint(0, 256, (2, 64, 96, 3)).astype(
        np.uint8)
    with torch.no_grad():
        y3 = m(_to_model_input(T(x), torch.float32))
        y12 = m(_to_model_input(T(space_to_depth(x)), torch.float32))
    assert y12.shape == y3.shape == (2, 4, 6, 1024)
    assert _rel(y12, y3) <= 1e-5


@pytest.fixture(scope="module")
def flagship():
    return harness.flagship()


def test_backbone_s2d_matches_ait_tpu(flagship):
    _, jm, params, _, pm = flagship
    image, _, _ = harness.batch(2)
    x12 = space_to_depth(image)

    def backbone(m, x):
        return m.backbone(jax_input(x, m.dtype))

    want = jax.jit(lambda p, x: jm.apply({"params": p}, x,
                                         method=backbone))(params, x12)
    with torch.inference_mode():
        got = pm.backbone(_to_model_input(T(x12), torch.float32))
        got3 = pm.backbone(_to_model_input(T(image), torch.float32))
    assert _rel(got, want) <= 1e-5
    assert _rel(got3, want) <= 1e-5


@pytest.fixture(scope="module")
def loader_batch(tmp_path_factory):
    """One eval batch of 2 from the port's loader on the VOC fixture, with
    `Config()`'s canvas, uint8 and host space-to-depth unchanged."""
    devkit = make_voc_devkit(str(tmp_path_factory.mktemp("VOCdevkit2007")))
    view = filter_seen(load_voc(devkit, "2007", "test"), 2)
    batch = next(OneShotLoader(view, Config(), training=False).test_epoch(
        2, num_workers=2))
    assert batch["image"].shape == (2, 304, 400, 12)
    assert batch["image"].dtype == np.uint8
    return batch


def test_detector_s2d_batch_matches_ait_tpu(flagship, loader_batch):
    cfg, jm, params, _, pm = flagship
    image, query, info = (loader_batch[k] for k in ("image", "query",
                                                    "im_info"))
    b = image.shape[0]
    gt = jnp.zeros((b, cfg.MAX_NUM_GT_BOXES, 5))
    nb = jnp.zeros((b,), jnp.int32)
    jout = jax.jit(lambda p, i, q, ii: jm.apply(
        {"params": p}, i, q, ii, gt, nb, train=False))(params, image, query,
                                                        info)
    with torch.inference_mode():
        pout = pm(T(image), T(query), T(info))
    for name, atol in (("rois", 1e-2), ("cls_prob", 1e-5),
                       ("bbox_pred", 1e-4)):
        want = np.asarray(getattr(jout, name))
        got = getattr(pout, name).numpy()
        assert got.shape == want.shape, name
        assert np.isfinite(got).all(), name
        np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                   err_msg=name)
