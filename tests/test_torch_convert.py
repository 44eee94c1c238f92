"""The port's `.pth` converters (ait_tpu_torch/convert.py) and its tool
(`python -m ait_tpu_torch.tools.convert_torch_checkpoint`) against
ait_tpu's.

The reference's checkpoints are not in this environment, so the
state_dicts are written from numpy-seeded JAX-layout trees under the
reference's names (`convert.reference_state_dict`, the inverse of the
converter's rules, held here to ait_tpu's converter): a ResNet-50 VOC
detector (the MHA co-attention), a ResNet-50 COCO detector (the non-local
co-attention) with the contextual relation, the ResNet-50 backbone
pretrain, and the vgg16 pretrain.

* Each of the three converters gives ait_tpu's tree, leaf for leaf and bit
  for bit, and that tree is the one the state_dict was written from.
* The tool writes ait_tpu's tool's pickle byte for byte; the port's
  `load_pretrained` of it gives the model ait_tpu's `load_pretrained` gives
  (the whole tree and a backbone-only pickle), and the tiny flagship's eval
  forward from it equals ait_tpu's within tests/test_torch_a20.py's
  tolerances.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_harness as harness
import __graft_entry__ as graft
from ait_tpu import convert as jconvert
from ait_tpu.models import AITDetector as JaxDetector
from ait_tpu.models.vgg import VGGBackbone as JaxVGG
from ait_tpu.models.vgg import VGGTop as JaxVGGTop
from ait_tpu_torch import bridge, convert
from ait_tpu_torch.convert import reference_state_dict
from ait_tpu_torch.models import AITDetector
from ait_tpu_torch.tools import convert_torch_checkpoint as tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import convert_torch_checkpoint as jtool  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _detector_tree(flavour, seed):
    cfg, _ = graft._flagship(tiny=True)
    if flavour == "coco":
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, coattention="nonlocal", with_contextual_relation=True))
    jm = JaxDetector(cfg, dtype=jnp.float32)
    g = graft._batch(1, harness.H, harness.W, g=cfg.MAX_NUM_GT_BOXES)
    shapes = harness.jax_shapes(jm, g["image"], g["query"], g["im_info"],
                                g["gt_boxes"], g["num_boxes"], train=False)
    return cfg, jm, bridge.random_tree(shapes, seed)


def _same_trees(got, want):
    g, w = dict(leaves(got)), dict(leaves(want))
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        np.testing.assert_array_equal(g[k], w[k], err_msg="/".join(k))


@pytest.mark.parametrize("flavour", ["voc", "coco"])
def test_convert_detector_matches_ait_tpu(flavour):
    _, _, tree = _detector_tree(flavour, seed=1)
    sd = reference_state_dict(tree)
    sd["RCNN_base.layer1.0.bn1.num_batches_tracked"] = torch.tensor(0)
    sd["transformer.encoder.position_enc.pos_table"] = torch.zeros(1, 64, 8)
    got = convert.convert_detector(sd)
    _same_trees(got, jconvert.convert_detector(sd))
    _same_trees(got, tree)                 # every leaf, back where it was


def _resnet_pretrain(tree):
    """ImageNet ResNet-50 keys (model_best.pth.tar, DataParallel-wrapped)
    for the backbone and top of a detector tree."""
    sd = {"module.fc.weight": torch.zeros(1000, 2048),
          "module.fc.bias": torch.zeros(1000)}
    for p, v in leaves(tree):
        if p[0] not in ("backbone", "top"):
            continue
        name = convert._reference_name(p)
        name = name.replace("RCNN_base.stem.0", "conv1").replace(
            "RCNN_base.stem.1", "bn1").replace("RCNN_base.", "").replace(
            "RCNN_top.0", "layer4")
        sd["module." + name] = torch.from_numpy(
            convert._reference_layout(p, v))
    return sd


def test_convert_backbone_matches_ait_tpu():
    _, _, tree = _detector_tree("voc", seed=2)
    sd = _resnet_pretrain(tree)
    got = convert.convert_backbone(sd)
    _same_trees(got, jconvert.convert_backbone(sd))
    _same_trees(got, {"backbone": tree["backbone"], "top": tree["top"]})


def test_convert_vgg_backbone_matches_ait_tpu():
    x = jnp.zeros((1, 32, 32, 3))
    shapes = harness.jax_shapes(JaxVGG(), x)
    tshapes = harness.jax_shapes(JaxVGGTop(), jnp.zeros((1, 7, 7, 512)))
    tree = {"backbone": bridge.random_tree(shapes, 3),
            "top": bridge.random_tree(tshapes, 4)}
    index = {v: k for k, v in jconvert._VGG_FEATURES.items()}
    sd = {}
    for conv, leaf in tree["backbone"].items():
        sd[f"features.{index[conv]}.weight"] = torch.from_numpy(
            convert._reference_layout(("kernel",), leaf["kernel"]))
        sd[f"features.{index[conv]}.bias"] = torch.from_numpy(leaf["bias"])
    # torch flattens fc6's input [C, 7, 7]: the inverse of _vgg_fc6
    fc6 = tree["top"]["fc6"]["kernel"]                     # [7*7*512, 4096]
    sd["classifier.0.weight"] = torch.from_numpy(np.ascontiguousarray(
        fc6.reshape(7, 7, 512, 4096).transpose(3, 2, 0, 1).reshape(4096, -1)))
    sd["classifier.0.bias"] = torch.from_numpy(tree["top"]["fc6"]["bias"])
    sd["classifier.3.weight"] = torch.from_numpy(np.ascontiguousarray(
        tree["top"]["fc7"]["kernel"].T))
    sd["classifier.3.bias"] = torch.from_numpy(tree["top"]["fc7"]["bias"])
    sd["classifier.6.weight"] = torch.zeros(1000, 4096)
    got = convert.convert_vgg_backbone(sd)
    _same_trees(got, jconvert.convert_vgg_backbone(sd))
    _same_trees(got, tree)


def _write_pth(path, sd, released):
    blob = ({"session": 1, "epoch": 3, "model": sd, "pooling_mode": "align",
             "class_agnostic": True} if released
            else {"state_dict": sd})
    torch.save(blob, path)


def test_tool_pickle_and_forward_match_ait_tpu(tmp_path, capsys):
    cfg, jm, tree = _detector_tree("voc", seed=5)
    pth = str(tmp_path / "released.pth")
    _write_pth(pth, {"module." + k: v for k, v in
                     reference_state_dict(tree).items()}, released=True)
    ours, theirs = str(tmp_path / "port.pkl"), str(tmp_path / "jax.pkl")
    tool.main(["--input", pth, "--output", ours])
    jtool.main(["--input", pth, "--output", theirs])
    assert "converted detector checkpoint" in capsys.readouterr().out
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()

    # onto other random weights: the pickle replaces every leaf
    base = bridge.random_tree(bridge.jax_shapes(AITDetector(
        harness.port_config(cfg))), 6)
    jparams, n_j = jconvert.load_pretrained(base, theirs)
    pm = AITDetector(harness.port_config(cfg), dtype=torch.float32)
    pm.load_state_dict(bridge.to_state_dict(pm, base))
    assert convert.load_pretrained(pm, ours) == n_j
    _same_trees(bridge.to_jax_tree(pm, pm.state_dict()),
                jax.tree_util.tree_map(np.asarray, jparams))
    pm.eval()
    image, query, info = harness.batch(2)
    gt = jnp.zeros((2, cfg.MAX_NUM_GT_BOXES, 5))
    jout = jax.jit(lambda p: jm.apply({"params": p}, image, query, info, gt,
                                      jnp.zeros((2,), jnp.int32)))(jparams)
    with torch.inference_mode():
        pout = pm(*(torch.from_numpy(np.array(a))
                    for a in (image, query, info)))
    for name, atol in (("rois", 1e-2), ("cls_prob", 1e-5),
                       ("bbox_pred", 1e-4)):
        np.testing.assert_allclose(getattr(pout, name).numpy(),
                                   np.asarray(getattr(jout, name)), rtol=0,
                                   atol=atol, err_msg=name)


def test_tool_backbone_pickle_overlays_like_ait_tpu(tmp_path):
    cfg, _, tree = _detector_tree("voc", seed=7)
    pth = str(tmp_path / "model_best.pth.tar")
    _write_pth(pth, _resnet_pretrain(tree), released=False)
    ours, theirs = str(tmp_path / "port.pkl"), str(tmp_path / "jax.pkl")
    kind, _ = tool.convert_file(pth)
    assert kind == "backbone"
    tool.main(["--input", pth, "--output", ours])
    jtool.main(["--input", pth, "--output", theirs])
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    base = bridge.random_tree(bridge.jax_shapes(AITDetector(
        harness.port_config(cfg))), 8)
    jparams, n_j = jconvert.load_pretrained(base, theirs)
    pm = AITDetector(harness.port_config(cfg))
    pm.load_state_dict(bridge.to_state_dict(pm, base))
    assert convert.load_pretrained(pm, ours) == n_j > 0
    _same_trees(bridge.to_jax_tree(pm, pm.state_dict()),
                jax.tree_util.tree_map(np.asarray, jparams))
