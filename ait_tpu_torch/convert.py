"""Reference `.pth` weights into the port (counterpart of ait_tpu/convert.py).

Three converters, numpy only, give the same JAX-layout tree as the JAX
package's for the same state_dict:

* `convert_backbone`: a reduced-ImageNet ResNet pretrain
  (model_best.pth.tar's `state_dict`, `module.` prefixes stripped) ->
  {'backbone', 'top'};
* `convert_vgg_backbone`: torchvision / caffe vgg16 (vgg16_caffe.pth) ->
  conv1_1 .. conv5_3 and fc6 / fc7, fc6's input reordered from torch's CHW
  flatten to the port's HWC (`_vgg_fc6`);
* `convert_detector`: a released detector checkpoint's `model` state_dict
  (the VOC MHA and the COCO non-local layouts, the contextual relation's
  convs, GRU/LSTM and fc) -> the detector's tree.

Layouts: conv [O, I, kh, kw] -> [kh, kw, I, O], linear [O, I] -> [I, O],
BatchNorm {weight, bias, running_mean, running_var} -> FrozenBatchNorm
{scale, bias, mean, var}.  `python -m
ait_tpu_torch.tools.convert_torch_checkpoint` writes the tree as the same
pickle as the JAX package's tool.

`load_pretrained` overlays such a pickle (the whole detector's tree or a
part of it, a backbone-only pretrain) onto a port model; the layout
changes to the port's tensors are the weight bridge's (`bridge.mappings`).
The pickle is read by an unpickler that builds only builtins and numpy
arrays.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch
from torch import nn

from ait_tpu_torch import bridge
from ait_tpu_torch.data.coco import read_data_pickle


def _array(val) -> np.ndarray:
    """A state_dict value (a torch tensor or an array) as numpy."""
    if isinstance(val, torch.Tensor):
        return val.detach().cpu().numpy()
    return np.asarray(val)


def _set(tree: dict, path, value):
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def _conv(w) -> np.ndarray:
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def _linear(w) -> np.ndarray:
    return np.asarray(w).T


_BN_LEAF = {"weight": "scale", "bias": "bias",
            "running_mean": "mean", "running_var": "var"}


def _bn(path, leaf, value, out):
    _set(out, path + (_BN_LEAF[leaf],), np.asarray(value))


def _norm_leaf(leaf: str) -> str:
    return {"weight": "scale", "bias": "bias"}[leaf]


def convert_backbone(state_dict: Dict[str, "object"],
                     strip_module: bool = True) -> dict:
    """ImageNet-pretrain resnet state_dict -> {'backbone':..., 'top':...}."""
    out: dict = {}
    for key, val in state_dict.items():
        if strip_module and key.startswith("module."):
            key = key[len("module."):]
        parts = key.split(".")
        if parts[0] in ("fc", "avgpool"):
            continue
        if parts[-1] == "num_batches_tracked":
            continue
        val = _array(val)
        if parts[0] == "conv1":
            _set(out, ("backbone", "conv1", "kernel"), _conv(val))
        elif parts[0] == "bn1":
            _bn(("backbone", "bn1"), parts[1], val, out)
        elif re.fullmatch(r"layer[1-4]", parts[0]):
            layer = parts[0]
            root = ("top", "layer4") if layer == "layer4" else ("backbone",
                                                               layer)
            block = f"block{parts[1]}"
            mod, leaf = parts[2], parts[3]
            if mod.startswith("conv"):
                _set(out, root + (block, mod, "kernel"), _conv(val))
            elif mod.startswith("bn"):
                _bn(root + (block, mod), leaf, val, out)
            elif mod == "downsample":
                idx, leaf = parts[3], parts[4]
                if idx == "0":
                    _set(out, root + (block, "downsample_conv", "kernel"),
                         _conv(val))
                else:
                    _bn(root + (block, "downsample_bn"), leaf, val, out)
    return out


# torchvision vgg16 features index -> conv name (vgg16.py:38 uses
# features[:-1]; indices skip the interleaved ReLU/MaxPool modules)
_VGG_FEATURES = {0: "conv1_1", 2: "conv1_2", 5: "conv2_1", 7: "conv2_2",
                 10: "conv3_1", 12: "conv3_2", 14: "conv3_3",
                 17: "conv4_1", 19: "conv4_2", 21: "conv4_3",
                 24: "conv5_1", 26: "conv5_2", 28: "conv5_3"}


def _vgg_fc6(w: np.ndarray) -> np.ndarray:
    """classifier.0 weight [4096, C*H*W] (torch CHW flatten order) ->
    [H*W*C, 4096] (the HWC flatten order of the JAX layout and the port).
    H = W = 7, C = 512."""
    o, i = np.asarray(w).shape
    c, s = 512, int(round((i / 512) ** 0.5))
    assert c * s * s == i, f"unexpected fc6 in-dim {i}"
    return (np.asarray(w).reshape(o, c, s, s)
            .transpose(2, 3, 1, 0).reshape(i, o))


def convert_vgg_backbone(state_dict: Dict[str, "object"],
                         strip_module: bool = True) -> dict:
    """torchvision/caffe-layout vgg16 state_dict (vgg16_caffe.pth,
    vgg16.py:31-33) -> {'backbone': conv1_1..conv5_3, 'top': fc6/fc7}.

    classifier.6 (the 1000-way head) is dropped — the reference keeps
    classifier[:-1] (vgg16.py:35).  fc6 gets the CHW->HWC input-dim
    permutation (torch flattens [C, 7, 7]; the port flattens [7, 7, C]).
    """
    out: dict = {}
    for key, val in state_dict.items():
        if strip_module and key.startswith("module."):
            key = key[len("module."):]
        parts = key.split(".")
        val = _array(val)
        if parts[0] == "features" and int(parts[1]) in _VGG_FEATURES:
            name = _VGG_FEATURES[int(parts[1])]
            if parts[2] == "weight":
                _set(out, ("backbone", name, "kernel"), _conv(val))
            else:
                _set(out, ("backbone", name, "bias"), val)
        elif parts[0] == "classifier" and parts[1] in ("0", "3"):
            name = "fc6" if parts[1] == "0" else "fc7"
            if parts[2] == "weight":
                w = _vgg_fc6(val) if name == "fc6" else _linear(val)
                _set(out, ("top", name, "kernel"), w)
            else:
                _set(out, ("top", name, "bias"), val)
    return out


# the MHA and FFN leaves: torch name suffix -> (JAX path, layout change)
_MHA_SUBS = [
    ("w_qs.weight", ("w_qs", "kernel"), _linear),
    ("w_ks.weight", ("w_ks", "kernel"), _linear),
    ("w_vs.weight", ("w_vs", "kernel"), _linear),
    ("fc.weight", ("fc", "kernel"), _linear),
    ("sh.sk.weight", ("sh", "sk", "kernel"), _linear),
    ("sh.sk.bias", ("sh", "sk", "bias"), np.asarray),
    ("layer_norm.weight", ("LayerNorm_0", "scale"), np.asarray),
    ("layer_norm.bias", ("LayerNorm_0", "bias"), np.asarray),
]

_FFN_SUBS = [
    ("w_1.weight", ("w_1", "kernel"), _linear),
    ("w_1.bias", ("w_1", "bias"), np.asarray),
    ("w_2.weight", ("w_2", "kernel"), _linear),
    ("w_2.bias", ("w_2", "bias"), np.asarray),
    ("layer_norm.weight", ("LayerNorm_0", "scale"), np.asarray),
    ("layer_norm.bias", ("LayerNorm_0", "bias"), np.asarray),
]


def _match_subs(rest: str, subs, base_path, out, val) -> bool:
    for suffix, path, fn in subs:
        if rest == suffix:
            _set(out, base_path + path, fn(val))
            return True
    return False


def convert_detector(state_dict: Dict[str, "object"]) -> dict:
    """Full detector state_dict ('model' entry of a released ckpt)."""
    out: dict = {}
    for key, val in state_dict.items():
        if key.startswith("module."):
            key = key[len("module."):]
        val = _array(val)
        parts = key.split(".")
        if parts[-1] == "num_batches_tracked":
            continue
        if "pos_table" in key:
            continue  # deterministic sinusoid buffer
        if parts[0] == "RCNN_base":
            if parts[1] == "backbone":
                continue  # aliases of stem./layerN. tensors
            # optional contextual-relation branch (resnet_sys…:277-317)
            m = re.fullmatch(r"trans([123])", parts[1])
            if m:
                leaf = "kernel" if parts[3] == "weight" else "bias"
                _set(out, ("contextual", f"trans{m.group(1)}", leaf),
                     _conv(val) if leaf == "kernel" else val)
                continue
            if parts[1] == "rnn":
                m = re.fullmatch(r"(weight|bias)_(ih|hh)_l(\d+)(_reverse)?",
                                 parts[2])
                kind, gate, layer, rev = m.groups()
                d = f"l{layer}_bw" if rev else f"l{layer}_fw"
                leaf = ("w_" if kind == "weight" else "b_") + gate
                _set(out, ("contextual", d, leaf),
                     _linear(val) if kind == "weight" else np.asarray(val))
                continue
            if parts[1] == "fc":
                leaf = "kernel" if parts[3] == "weight" else "bias"
                _set(out, ("contextual", "fc", leaf),
                     _linear(val) if leaf == "kernel" else val)
                continue
            if parts[1] == "stem":
                if parts[2] == "0":
                    _set(out, ("backbone", "conv1", "kernel"), _conv(val))
                else:
                    _bn(("backbone", "bn1"), parts[3], val, out)
                continue
            layer, block = parts[1], f"block{parts[2]}"
            root = ("backbone", layer, block)
            mod = parts[3]
            if mod.startswith("conv"):
                _set(out, root + (mod, "kernel"), _conv(val))
            elif mod.startswith("bn"):
                _bn(root + (mod,), parts[4], val, out)
            elif mod == "downsample":
                if parts[4] == "0":
                    _set(out, root + ("downsample_conv", "kernel"),
                         _conv(val))
                else:
                    _bn(root + ("downsample_bn",), parts[5], val, out)
            continue
        if parts[0] == "RCNN_top":
            block = f"block{parts[2]}"
            root = ("top", "layer4", block)
            mod = parts[3]
            if mod.startswith("conv"):
                _set(out, root + (mod, "kernel"), _conv(val))
            elif mod.startswith("bn"):
                _bn(root + (mod,), parts[4], val, out)
            elif mod == "downsample":
                if parts[4] == "0":
                    _set(out, root + ("downsample_conv", "kernel"),
                         _conv(val))
                else:
                    _bn(root + ("downsample_bn",), parts[5], val, out)
            continue
        if parts[0] == "RCNN_rpn":
            name = {"RPN_Conv": "conv", "RPN_cls_score": "cls_score",
                    "RPN_bbox_pred": "bbox_pred"}[parts[1]]
            leaf = "kernel" if parts[2] == "weight" else "bias"
            _set(out, ("rpn", name, leaf),
                 _conv(val) if leaf == "kernel" else val)
            continue
        if parts[0] == "RCNN_cls_score":
            leaf = "kernel" if parts[2] == "weight" else "bias"
            _set(out, (f"cls_score_{parts[1]}", leaf),
                 _linear(val) if leaf == "kernel" else val)
            continue
        if parts[0] == "RCNN_bbox_pred":
            leaf = "kernel" if parts[1] == "weight" else "bias"
            _set(out, ("bbox_pred_head", leaf),
                 _linear(val) if leaf == "kernel" else val)
            continue
        if parts[0] in ("coattention", "coattention_module"):
            rest = ".".join(parts[1:])
            # VOC MHA flavor (faster_rcnn_sys_transformer_sk_dilat.py:31-64)
            for emb in ("img_emb", "qry_emb"):
                if rest.startswith(emb + ".0."):
                    leaf = "kernel" if rest.endswith("weight") else "bias"
                    _set(out, ("coattention", emb, leaf),
                         _conv(val) if leaf == "kernel" else val)
                    break
            else:
                for tr in ("img_trans", "qry_trans"):
                    if rest.startswith(tr + ".0."):
                        leaf = "kernel" if rest.endswith("weight") else "bias"
                        _set(out, ("coattention", tr, leaf),
                             _linear(val) if leaf == "kernel" else val)
                        break
                else:
                    m = re.match(r"(i2q_attn|q2i_attn)\.(.+)", rest)
                    if m and _match_subs(m.group(2), _MHA_SUBS,
                                         ("coattention", m.group(1)), out,
                                         val):
                        continue
                    # COCO non-local flavor (blocks_coatt:17-58)
                    m = re.match(r"coattention\.(emb|rho|phi)\.(weight|bias)",
                                 rest)
                    if m:
                        leaf = "kernel" if m.group(2) == "weight" else "bias"
                        _set(out, ("coattention", m.group(1), leaf),
                             _conv(val) if leaf == "kernel" else val)
                        continue
                    m = re.match(r"coattention\.(omega|theta)\.(0|1)\."
                                 r"(weight|bias)", rest)
                    if m:
                        name, idx, leaf = m.groups()
                        if idx == "0":
                            _set(out, ("coattention", f"{name}_conv",
                                       "kernel" if leaf == "weight"
                                       else "bias"),
                                 _conv(val) if leaf == "weight" else val)
                        else:
                            _set(out, ("coattention", f"{name}_gn",
                                       "GroupNorm_0", _norm_leaf(leaf)),
                                 val)
                        continue
            continue
        if parts[0] == "transformer":
            rest = ".".join(parts[1:])
            for emb in ("enc_emb", "dec_emb", "dec_trans"):
                if rest.startswith(emb + ".0."):
                    leaf = "kernel" if rest.endswith("weight") else "bias"
                    _set(out, ("transformer", emb, leaf),
                         _conv(val) if leaf == "kernel" else val)
                    break
            else:
                m = re.match(
                    r"(encoder|decoder)\.layer_norm\.(weight|bias)", rest)
                if m:
                    name = ("enc_in_ln" if m.group(1) == "encoder"
                            else "dec_in_ln")
                    _set(out, ("transformer", name, _norm_leaf(m.group(2))),
                         val)
                    continue
                m = re.match(r"(encoder|decoder)\.layer_stack\.(\d+)\."
                             r"(slf_attn|enc_attn|pos_ffn)\.(.+)", rest)
                if m:
                    side = "enc" if m.group(1) == "encoder" else "dec"
                    base = ("transformer", f"{side}_layer{m.group(2)}",
                            m.group(3))
                    subs = _FFN_SUBS if m.group(3) == "pos_ffn" else _MHA_SUBS
                    _match_subs(m.group(4), subs, base, out, val)
                    continue
            continue
        if parts[0] == "sk":
            rest = ".".join(parts[2:])
            branch = parts[1]
            mm = re.match(r"convs\.(\d)\.0\.(weight|bias)", rest)
            if mm:
                leaf = "kernel" if mm.group(2) == "weight" else "bias"
                _set(out, ("sk", branch, f"conv{mm.group(1)}", leaf),
                     _conv(val) if leaf == "kernel" else val)
                continue
            mm = re.match(r"(fc|sk)\.(weight|bias)", rest)
            if mm:
                # gate params exist only in sk_gate='fixed' models; kept in
                # the tree either way so overlay can skip them
                leaf = "kernel" if mm.group(2) == "weight" else "bias"
                _set(out, ("sk", branch, mm.group(1), leaf),
                     _linear(val) if leaf == "kernel" else val)
                continue
            continue
    return out




# ---------------------------------------------------------------------------
# the other way: a JAX-layout tree under the reference's names

def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


_REF_BN = {v: k for k, v in _BN_LEAF.items()}
_REF_SUBS = {path: name for name, path, _ in _MHA_SUBS + _FFN_SUBS}


def _reference_layout(path, v):
    """A JAX leaf in the reference's torch layout."""
    if path[-1] == "kernel" and v.ndim == 4:
        return np.ascontiguousarray(np.transpose(v, (3, 2, 0, 1)))
    if path[-1] in ("kernel", "w_ih", "w_hh"):
        return np.ascontiguousarray(v.T)
    return v


def _reference_name(path):
    """The reference's state_dict key of a detector leaf (the inverse of
    convert_detector's rules)."""
    head, leaf = path[:-1], path[-1]
    w = "weight" if leaf == "kernel" else leaf
    if head[0] in ("backbone", "top"):
        if head == ("backbone", "conv1"):
            return "RCNN_base.stem.0.weight"
        if head == ("backbone", "bn1"):
            return f"RCNN_base.stem.1.{_REF_BN[leaf]}"
        root = ("RCNN_base." + head[1] if head[0] == "backbone"
                else "RCNN_top.0")
        block, mod = head[2][len("block"):], head[3]
        if mod == "downsample_conv":
            return f"{root}.{block}.downsample.0.weight"
        if mod == "downsample_bn":
            return f"{root}.{block}.downsample.1.{_REF_BN[leaf]}"
        if mod.startswith("bn"):
            return f"{root}.{block}.{mod}.{_REF_BN[leaf]}"
        return f"{root}.{block}.{mod}.weight"
    if head[0] == "contextual":
        mod = head[1]
        if mod.startswith("trans") or mod == "fc":
            return f"RCNN_base.{mod}.0.{w}"
        layer, rev = mod[1:].split("_")
        kind = "weight" if leaf.startswith("w_") else "bias"
        return (f"RCNN_base.rnn.{kind}_{leaf[2:]}_l{layer}"
                + ("_reverse" if rev == "bw" else ""))
    if head[0] == "rpn":
        name = {"conv": "RPN_Conv", "cls_score": "RPN_cls_score",
                "bbox_pred": "RPN_bbox_pred"}[head[1]]
        return f"RCNN_rpn.{name}.{w}"
    if head[0].startswith("cls_score_"):
        return f"RCNN_cls_score.{head[0][-1]}.{w}"
    if head[0] == "bbox_pred_head":
        return f"RCNN_bbox_pred.{w}"
    if head[0] == "coattention":
        mod = head[1]
        if mod in ("img_emb", "qry_emb", "img_trans", "qry_trans"):
            return f"coattention.{mod}.0.{w}"
        if mod in ("q2i_attn", "i2q_attn"):
            return f"coattention.{mod}.{_REF_SUBS[head[2:] + (leaf,)]}"
        if mod in ("emb", "rho", "phi"):
            return f"coattention.coattention.{mod}.{w}"
        name, part = mod.split("_")
        idx = "0" if part == "conv" else "1"
        nleaf = {"kernel": "weight", "scale": "weight", "bias": "bias"}[leaf]
        return f"coattention.coattention.{name}.{idx}.{nleaf}"
    if head[0] == "transformer":
        mod = head[1]
        if mod in ("enc_emb", "dec_emb", "dec_trans"):
            return f"transformer.{mod}.0.{w}"
        if mod in ("enc_in_ln", "dec_in_ln"):
            side = "encoder" if mod == "enc_in_ln" else "decoder"
            return f"transformer.{side}.layer_norm.{_REF_BN[leaf]}"
        side = "encoder" if mod.startswith("enc") else "decoder"
        return (f"transformer.{side}.layer_stack.{mod[-1]}.{head[2]}."
                f"{_REF_SUBS[head[3:] + (leaf,)]}")
    if head[0] == "sk":
        mod = head[2]
        if mod.startswith("conv"):
            return f"sk.{head[1]}.convs.{mod[-1]}.0.{w}"
        return f"sk.{head[1]}.{mod}.{w}"
    raise KeyError("/".join(path))


def reference_state_dict(tree: dict) -> Dict[str, torch.Tensor]:
    """A detector's JAX-layout tree as the reference's state_dict (its
    names and torch layouts): the inverse of `convert_detector`, so a
    port model's weights can be written as a reference `.pth`
    (`{'model': reference_state_dict(bridge.to_jax_tree(model,
    model.state_dict()))}`)."""
    return {_reference_name(p): torch.from_numpy(_reference_layout(p, v))
            for p, v in _leaves(tree)}


def _overlay(shapes: dict, loaded: dict, prefix: tuple,
             out: Dict[tuple, np.ndarray]) -> None:
    """Walk the pickle's tree against the model's JAX-layout shapes, as
    ait_tpu.convert.load_pretrained does: keys the model lacks are skipped,
    a subtree against a leaf (or the reverse) or a wrong shape raises."""
    for k, v in loaded.items():
        if k not in shapes:
            continue
        path = prefix + (k,)
        name = "/".join(path)
        if isinstance(v, dict):
            if not isinstance(shapes[k], dict):
                raise ValueError(
                    f"structure mismatch at '{name}': the pickle has a "
                    f"subtree but the model has a leaf {shapes[k]}")
            _overlay(shapes[k], v, path, out)
            continue
        if isinstance(shapes[k], dict):
            raise ValueError(
                f"structure mismatch at '{name}': the pickle has a leaf "
                f"{np.shape(v)} but the model has a subtree")
        if tuple(np.shape(v)) != tuple(shapes[k]):
            raise ValueError(f"shape mismatch at '{name}': the pickle has "
                             f"{np.shape(v)}, the model {shapes[k]}")
        out[path] = np.asarray(v, np.float32)


def load_pretrained(model: nn.Module, path: str) -> int:
    """Overlay a converted params pickle onto `model` in place; returns
    the number of arrays loaded."""
    loaded = read_data_pickle(path)
    if not isinstance(loaded, dict):
        raise ValueError(f"{path}: a params pickle holds a nested dict, "
                         f"not {type(loaded).__name__}")
    found: Dict[tuple, np.ndarray] = {}
    _overlay(bridge.jax_shapes(model), loaded, (), found)
    state = model.state_dict()
    with torch.no_grad():
        for key, leaf, _, fn in bridge.mappings(model):
            if leaf in found:
                arr = found[leaf]
                t = state[key]
                t.copy_(torch.from_numpy(np.ascontiguousarray(
                    fn(arr) if fn is not None else arr)).to(t.device,
                                                            t.dtype))
    return len(found)
