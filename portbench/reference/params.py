"""The detector's leaves and their shapes, from the configuration alone.

Names and layouts follow the model's published JAX tree as the program's
`state_dict` spells it: convolution kernels [O, I/g, kh, kw], dense weights
[O, I] with a bias [O], attention and FFN kernels [in, out] under
`.kernel`, FrozenBN's four arrays, LayerNorm's scale and bias.
"""

from __future__ import annotations

from typing import Dict, Tuple

from .model import STAGES

Shapes = Dict[str, Tuple[int, ...]]


def _conv(out: Shapes, name, cin, cout, k, groups=1, bias=True):
    out[name + ".weight"] = (cout, cin // groups, k, k)
    if bias:
        out[name + ".bias"] = (cout,)


def _bn(out: Shapes, name, c):
    for leaf in ("scale", "bias", "mean", "var"):
        out[f"{name}.{leaf}"] = (c,)


def _dense(out: Shapes, name, cin, cout):
    out[name + ".weight"] = (cout, cin)
    out[name + ".bias"] = (cout,)


def _stage(out: Shapes, name, cin, planes, blocks):
    for i in range(blocks):
        b = f"{name}.block{i}"
        c = cin if i == 0 else planes * 4
        _conv(out, b + ".conv1", c, planes, 1, bias=False)
        _bn(out, b + ".bn1", planes)
        _conv(out, b + ".conv2", planes, planes, 3, bias=False)
        _bn(out, b + ".bn2", planes)
        _conv(out, b + ".conv3", planes, planes * 4, 1, bias=False)
        _bn(out, b + ".bn3", planes * 4)
        if i == 0:
            _conv(out, b + ".downsample_conv", c, planes * 4, 1, bias=False)
            _bn(out, b + ".downsample_bn", planes * 4)


def _attention(out: Shapes, name, d, n_head, d_k, d_v):
    out[name + ".w_qs.kernel"] = (d, n_head * d_k)
    out[name + ".w_ks.kernel"] = (d, n_head * d_k)
    out[name + ".w_vs.kernel"] = (d, n_head * d_v)
    out[name + ".sh.sk.kernel"] = (d_v, d_v * n_head)
    out[name + ".sh.sk.bias"] = (d_v * n_head,)
    out[name + ".fc.kernel"] = (d_v, d)
    out[name + ".LayerNorm_0.scale"] = (d,)
    out[name + ".LayerNorm_0.bias"] = (d,)


def _ffn(out: Shapes, name, d, hidden):
    out[name + ".w_1.kernel"] = (d, hidden)
    out[name + ".w_1.bias"] = (hidden,)
    out[name + ".w_2.kernel"] = (hidden, d)
    out[name + ".w_2.bias"] = (d,)
    out[name + ".LayerNorm_0.scale"] = (d,)
    out[name + ".LayerNorm_0.bias"] = (d,)


def param_shapes(cfg) -> Shapes:
    m = cfg["model"]
    n1, n2, n3, n4 = STAGES[m["backbone"]]
    ch, d = m["channels"], m["t_d_model"]
    heads = (m["t_n_head"], m["t_d_k"], m["t_d_v"])
    out: Shapes = {}
    _conv(out, "backbone.conv1", 3, 64, 7, bias=False)
    _bn(out, "backbone.bn1", 64)
    _stage(out, "backbone.layer1", 64, 64, n1)
    _stage(out, "backbone.layer2", 256, 128, n2)
    _stage(out, "backbone.layer3", 512, 256, n3)
    _stage(out, "top.layer4", 1024, 512, n4)
    half = ch // 2
    _conv(out, "coattention.img_emb", ch, half, 1)
    _conv(out, "coattention.qry_emb", ch, half, 1)
    _attention(out, "coattention.q2i_attn", half, *heads)
    _attention(out, "coattention.i2q_attn", half, *heads)
    _dense(out, "coattention.img_trans", half, ch)
    _dense(out, "coattention.qry_trans", half, ch)
    a = len(cfg["ANCHOR_SCALES"]) * len(cfg["ANCHOR_RATIOS"])
    _conv(out, "rpn.conv", ch, 512, 3)
    _conv(out, "rpn.cls_score", 512, 2 * a, 1)
    _conv(out, "rpn.bbox_pred", 512, 4 * a, 1)
    t = "transformer"
    _conv(out, t + ".enc_emb", ch, d, 1)
    _conv(out, t + ".dec_emb", ch, d, 1)
    for ln in ("enc_in_ln", "dec_in_ln"):
        out[f"{t}.{ln}.scale"] = (d,)
        out[f"{t}.{ln}.bias"] = (d,)
    for i in range(m["t_n_layers"]):
        _attention(out, f"{t}.enc_layer{i}.slf_attn", d, *heads)
        _ffn(out, f"{t}.enc_layer{i}.pos_ffn", d, m["t_d_inner"])
        _attention(out, f"{t}.dec_layer{i}.slf_attn", d, *heads)
        _attention(out, f"{t}.dec_layer{i}.enc_attn", d, *heads)
        _ffn(out, f"{t}.dec_layer{i}.pos_ffn", d, m["t_d_inner"])
    _conv(out, t + ".dec_trans", d, ch, 1)
    for s in ("sk.sk_props", "sk.sk_query"):
        _conv(out, s + ".conv0", ch, ch, 1, groups=8)
        _conv(out, s + ".conv1", ch, ch, 3, groups=8)
    _dense(out, "cls_score_0", 2 * 2048, 8)
    _dense(out, "cls_score_1", 8, 2)
    _dense(out, "bbox_pred_head", 2048, 4)
    return out


def frozen(key: str) -> bool:
    """Leaves that training leaves as they are: the stem convolution and
    every FrozenBN array (AIT's optimizer takes neither)."""
    return (key == "backbone.conv1.weight" or
            key.rsplit(".", 2)[-2] in ("bn1", "bn2", "bn3", "downsample_bn"))
