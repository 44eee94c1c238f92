"""The config paths the port used to refuse (ROADMAP A20) against ait_tpu,
float32 on the CPU, one numpy-seeded param tree on both sides through the
weight bridge:

* the tiny flagship's whole eval forward (full ResNet-50 widths, TEST tops
  32 -> 8, a 96x128 canvas) under t_attn_dist='division' (the plain
  attention path only, as JAX never fuses it), sk_gate='fixed' and
  class_agnostic=False (bbox_pred [B, R, 8]): rois within 1e-2 px,
  cls_prob within 1e-5 and bbox_pred within 1e-4, the tolerances of
  tests/test_torch_port_slice.py for the default forward;
* the res101 backbone and top at a 64x96 input: within 1e-4 of max |JAX|;
* `convert.load_pretrained` against JAX's on the same pickle (the full
  tree, a backbone-only tree, a tree with keys the model lacks), leaf by
  leaf through `bridge.to_jax_tree`, and its refusals;
* the 8-wide head's refusal by the train step and by the postprocess,
  where JAX's loss and postprocess fail too.
"""

import dataclasses
import datetime
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_harness as harness
import __graft_entry__ as graft
from ait_tpu import convert as jconvert
from ait_tpu.evaluation.postprocess import postprocess_detections as jpost
from ait_tpu.models import AITDetector as JaxDetector
from ait_tpu.models.resnet import ResNetBackbone as JaxBackbone
from ait_tpu.models.resnet import ResNetTop as JaxTop
from ait_tpu_torch import bridge
from ait_tpu_torch.config import Config
from ait_tpu_torch.convert import load_pretrained
from ait_tpu_torch.evaluation import postprocess_detections
from ait_tpu_torch.models import AITDetector
from ait_tpu_torch.models.resnet import ResNetBackbone, ResNetTop
from ait_tpu_torch.ops import fused_attention
from ait_tpu_torch.train import (init_weights, lr_schedule, make_optimizer,
                                 make_train_step)

KNOBS = {"division": {"t_attn_dist": "division"},
         "sk_fixed": {"sk_gate": "fixed"},
         "class_specific": {"class_agnostic": False}}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on the CPU's
    cores, and each torch process would otherwise start one a core."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def T(a):
    return torch.from_numpy(np.array(a))


def _forwards(knob):
    cfg, _ = graft._flagship(tiny=True)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, **KNOBS[knob]))
    jm = JaxDetector(cfg, dtype=jnp.float32)
    g = graft._batch(1, harness.H, harness.W, g=cfg.MAX_NUM_GT_BOXES)
    shapes = harness.jax_shapes(jm, g["image"], g["query"], g["im_info"],
                                g["gt_boxes"], g["num_boxes"], train=False)
    params = bridge.random_tree(shapes, 0)
    pm = AITDetector(harness.port_config(cfg), dtype=torch.float32)
    pm.load_state_dict(bridge.to_state_dict(pm, params))
    pm.eval()
    image, query, info = harness.batch(2)
    gt = jnp.zeros((2, cfg.MAX_NUM_GT_BOXES, 5))
    nb = jnp.zeros((2,), jnp.int32)
    jout = jax.jit(lambda p, i, q, ii: jm.apply(
        {"params": p}, i, q, ii, gt, nb, train=False))(params, image, query,
                                                        info)
    with torch.inference_mode():
        pout = pm(T(image), T(query), T(info))
    return jout, pout


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_eval_forward_matches_jax(knob, monkeypatch):
    calls = []
    real = fused_attention.sh_attention
    monkeypatch.setattr(fused_attention, "sh_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jout, pout = _forwards(knob)
    # the transformer's 3 attentions reach the fused attention except under
    # division (JAX fuses softmax only); the co-attention's 2 do at this
    # canvas (48 image tokens, 64 query tokens), under every knob
    assert len(calls) == (2 if knob == "division" else 5)
    width = 4 if knob != "class_specific" else 8
    assert pout.bbox_pred.shape[-1] == width
    for name, atol in (("rois", 1e-2), ("cls_prob", 1e-5),
                       ("bbox_pred", 1e-4)):
        want = np.asarray(getattr(jout, name))
        got = getattr(pout, name).numpy()
        assert got.shape == want.shape, name
        assert np.isfinite(got).all(), name
        np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                   err_msg=name)


def test_res101_backbone_and_top_match_jax():
    x = np.random.RandomState(0).randn(1, 64, 96, 3).astype(np.float32)
    jb = JaxBackbone("resnet101", dtype=jnp.float32)
    jt = JaxTop("resnet101", dtype=jnp.float32)
    feat_shape = (1, 4, 6, 1024)
    bshapes = harness.jax_shapes(jb, jnp.asarray(x))
    tshapes = harness.jax_shapes(jt, jnp.zeros(feat_shape))
    pb, pt = ResNetBackbone("resnet101"), ResNetTop("resnet101")
    assert bridge.jax_shapes(pb) == bshapes
    assert bridge.jax_shapes(pt) == tshapes
    assert len(bshapes["layer3"]) == 23
    bparams, tparams = (bridge.random_tree(s, i)
                        for i, s in enumerate((bshapes, tshapes)))
    pb.load_state_dict(bridge.to_state_dict(pb, bparams))
    pt.load_state_dict(bridge.to_state_dict(pt, tparams))
    jfeat = np.asarray(jb.apply({"params": bparams}, jnp.asarray(x)))
    jvec = np.asarray(jt.apply({"params": tparams}, jnp.asarray(jfeat)))
    with torch.no_grad():
        feat = pb(T(x)).numpy()
        vec = pt(T(jfeat)).numpy()
    assert feat.shape == feat_shape
    for got, want in ((feat, jfeat), (vec, jvec)):
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 1e-4, err


@pytest.fixture(scope="module")
def full_model():
    model = init_weights(AITDetector(Config()), 0)
    return model, bridge.to_jax_tree(model, model.state_dict())


def _pickles(tmp_path, base):
    other = bridge.random_tree(bridge.jax_shapes(AITDetector(Config())), 1)
    extra = dict(other, not_in_model={"kernel": np.zeros(3, np.float32)})
    extra["sk"] = dict(other["sk"], unknown_leaf=np.ones(2, np.float32))
    trees = {"full": other, "backbone": {"backbone": other["backbone"]},
             "extra_keys": extra}
    paths = {}
    for name, tree in trees.items():
        paths[name] = tmp_path / f"{name}.pkl"
        with open(paths[name], "wb") as f:
            pickle.dump(tree, f)
    return paths


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_load_pretrained_matches_jax(tmp_path, full_model):
    model, base = full_model
    for name, path in _pickles(tmp_path, base).items():
        m = AITDetector(Config())
        m.load_state_dict(model.state_dict())
        n = load_pretrained(m, str(path))
        jtree, jn = jconvert.load_pretrained(base, str(path))
        assert n == jn, name
        got = dict(_flat(bridge.to_jax_tree(m, m.state_dict())))
        want = dict(_flat(jtree))
        assert sorted(got) == sorted(want), name
        for leaf in want:
            np.testing.assert_array_equal(got[leaf], want[leaf],
                                          err_msg=f"{name}: {leaf}")
        if name == "backbone":
            assert n == len(list(_flat(base["backbone"])))


@pytest.mark.parametrize("bad,match", [
    ({"backbone": {"conv1": np.zeros(3, np.float32)}}, "structure"),
    ({"bbox_pred_head": {"kernel": {"x": np.zeros(1)}}}, "structure"),
    ({"bbox_pred_head": {"kernel": np.zeros((2048, 8), np.float32)}},
     "shape"),
])
def test_load_pretrained_refuses(tmp_path, full_model, bad, match):
    path = tmp_path / "bad.pkl"
    with open(path, "wb") as f:
        pickle.dump(bad, f)
    with pytest.raises(ValueError, match=match):
        load_pretrained(full_model[0], str(path))


def test_load_pretrained_refuses_other_classes(tmp_path, full_model):
    path = tmp_path / "obj.pkl"
    with open(path, "wb") as f:
        pickle.dump({"backbone": datetime.date(2026, 1, 1)}, f)
    with pytest.raises(pickle.UnpicklingError):
        load_pretrained(full_model[0], str(path))


def test_class_specific_head_refused_in_training_and_postprocess():
    cfg = Config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                class_agnostic=False))
    model = AITDetector(cfg)
    assert model.bbox_pred_head.weight.shape == (8, 2048)
    step = make_train_step(model, make_optimizer(cfg, model),
                           lr_schedule(0.01, 1, 1, 0.1), device="cpu")
    gt = np.zeros((1, 4, 5), np.float32)
    gt[0, 0] = [4, 4, 40, 40, 1]
    batch = {"image": np.zeros((1, 64, 64, 3), np.uint8),
             "query": np.zeros((1, 128, 128, 3), np.uint8),
             "im_info": np.float32([[64, 64, 1]]), "gt_boxes": gt}
    with pytest.raises(NotImplementedError, match="class_agnostic"):
        step(batch, torch.Generator().manual_seed(0))
    rois = np.zeros((1, 4, 5), np.float32)
    rois[0, :, 1:] = [4, 4, 30, 30]
    args = (rois, np.full((1, 4, 1), 0.5, np.float32),
            np.zeros((1, 4, 8), np.float32), np.float32([[64, 64, 1]]))
    with pytest.raises(ValueError, match="class-agnostic"):
        postprocess_detections(*(T(a) for a in args))
    with pytest.raises((TypeError, ValueError)):     # JAX fails on 8 too
        jpost(*(jnp.asarray(a) for a in args))
