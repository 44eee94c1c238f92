"""The predictor's shot-fused path (COCO's `test_coco.sh --a 4
--fuse_shots`) on the CPU, float32, the tiny COCO detector (the non-local
co-attention, 12 anchors a cell): a [U, A, q, q, 3] query served by
`predict_prepared` through `make_fused_eval_step` against the same pairs
served one image a pair, and against the benchmark's plain reference
(portbench/reference/coco.py, imported by path: it imports neither JAX nor
the port); the 4-D path as it was; the non-local co-attention against the
reference's; the spans and counters the fused path records.  No JAX."""

import dataclasses
import importlib
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from ait_tpu_torch.evaluation import postprocess_detections
from ait_tpu_torch.models.coattention import NonLocalCoAttention
from ait_tpu_torch.predict import OneShotPredictor
from ait_tpu_torch.train import make_eval_step
from ait_tpu_torch.utils.profiling import recording
from torch_parallel_workers import tiny_batch, tiny_cfg, tiny_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
U, A = 2, 4


def _reference():
    """portbench/reference as the package `portbench_reference`."""
    name = "portbench_reference"
    if name not in sys.modules:
        where = os.path.join(ROOT, "portbench", "reference")
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(where, "__init__.py"),
            submodule_search_locations=[where])
        pkg = importlib.util.module_from_spec(spec)
        sys.modules[name] = pkg
        spec.loader.exec_module(pkg)
    return (importlib.import_module(name + ".coco"),
            importlib.import_module(name + ".model"))


def _coco_cfg():
    cfg = tiny_cfg(coattention="nonlocal")
    return cfg.replace(ANCHOR_SCALES=(4, 8, 16, 32))


@pytest.fixture(scope="module")
def coco():
    """(cfg, its state_dict, the predictor, a batch of U images with A
    shots each).  The co-attention's GroupNorms get scale 1 and a small
    bias, so that the non-local branch (zero at init) counts."""
    torch.manual_seed(0)
    cfg = _coco_cfg()
    model = tiny_model(cfg)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for gn in (model.coattention.theta_gn, model.coattention.omega_gn):
            gn.GroupNorm_0.scale.fill_(1.0)
            gn.GroupNorm_0.bias.copy_(0.1 * torch.randn(
                gn.GroupNorm_0.bias.shape, generator=g))
    sd = model.state_dict()
    pred = OneShotPredictor(cfg, sd, device="cpu", dtype=torch.float32)
    b = tiny_batch(U, seed=7)
    rng = np.random.RandomState(8)
    shots = rng.randint(0, 256, (U, A, 128, 128, 3)).astype(np.uint8)
    return cfg, sd, pred, (b["image"].numpy(), shots, b["im_info"].numpy())


def _expanded(image, shots, info):
    return (np.repeat(image, A, axis=0), shots.reshape(U * A, 128, 128, 3),
            np.repeat(info, A, axis=0))


def test_fused_shots_serve_the_pairs_pair_major(coco):
    """U * A arrays, shot a of image u at u * A + a, equal to the same
    pairs served one image a pair."""
    _, _, pred, batch = coco
    fused = pred.predict_prepared(*batch)
    per_pair = pred.predict_prepared(*_expanded(*batch))
    assert len(fused) == U * A
    assert sum(len(d) for d in fused) > 0
    for got, want in zip(fused, per_pair):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_fused_shots_match_the_plain_reference(coco):
    cfg, sd, pred, batch = coco
    C, R = _reference()
    fused = pred.predict_prepared(*batch)
    ref_cfg = dataclasses.asdict(cfg)
    with torch.no_grad():
        _, _, _, dets, valid = C.detect(
            {k: v.float() for k, v in sd.items()}, ref_cfg,
            *[torch.as_tensor(x) for x in batch])
    assert dets.shape[0] == U * A
    for i, got in enumerate(fused):
        want = dets[i][valid[i]].numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_the_4d_path_is_the_eval_step_and_its_postprocess(coco):
    """A 4-D query runs make_eval_step and the postprocess on the batch's
    own im_info, as before the fused path was added."""
    cfg, _, pred, batch = coco
    image, shots, info = _expanded(*batch)
    got = pred.predict_prepared(image, shots, info)
    out = make_eval_step(pred.model)({"image": torch.as_tensor(image),
                                      "query": torch.as_tensor(shots),
                                      "im_info": torch.as_tensor(info)})
    dets, valid = postprocess_detections(
        out["rois"], out["cls_prob"], out["bbox_pred"],
        torch.as_tensor(info), nms_thresh=cfg.TEST.NMS, score_thresh=0.0,
        max_per_image=cfg.TEST.MAX_PER_IMAGE,
        bbox_normalize_means=cfg.TRAIN.BBOX_NORMALIZE_MEANS,
        bbox_normalize_stds=cfg.TRAIN.BBOX_NORMALIZE_STDS)
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g, dets[i][valid[i]].numpy())


def test_the_fused_path_records_its_gather_and_counts(coco):
    _, _, pred, batch = coco
    with recording() as rec:
        pred.predict_prepared(*batch)
        pred.predict_prepared(*_expanded(*batch))
    fused, per_pair = rec.roots()

    def under(root):
        i = rec.spans.index(root)
        return [s for s in rec.spans if s.root == i]

    gathers = [s for s in under(fused) if s.name == "ait:shots.gather"]
    assert len(gathers) == 1
    assert gathers[0].counts == {"fused_shots.images": U,
                                 "fused_shots.pairs": U * A}
    assert not [s for s in under(per_pair) if s.name == "ait:shots.gather"
                or s.counts.get("fused_shots.pairs")]


def test_nonlocal_coattention_matches_the_reference():
    C, R = _reference()
    g = torch.Generator().manual_seed(2)
    mod = NonLocalCoAttention(1024)
    W = {}
    for k, v in mod.state_dict().items():
        W["coattention." + k] = 0.05 * torch.randn(v.shape, generator=g)
    mod.load_state_dict({k[len("coattention."):]: v for k, v in W.items()})
    img = torch.randn(2, 1024, 6, 8, generator=g)
    qry = torch.randn(2, 1024, 8, 8, generator=g)
    want_i, want_q = C.nonlocal_coattention(W, img, qry, R.F32)
    with torch.no_grad():
        got_i, got_q = mod(img.permute(0, 2, 3, 1), qry.permute(0, 2, 3, 1))
    for got, want in ((got_i, want_i), (got_q, want_q)):
        np.testing.assert_allclose(got.permute(0, 3, 1, 2).numpy(),
                                   want.numpy(), rtol=1e-5, atol=1e-5)
