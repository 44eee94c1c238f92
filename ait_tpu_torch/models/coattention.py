"""Image <-> query co-attention, the VOC model's flavor (counterpart of
ait_tpu/models/coattention.py::MHACoAttention).

A 1x1-conv embed to 512, a pair of cross MultiHeadAttentions, and a linear
map back to 1024 (faster_rcnn_sys_transformer_sk_dilat.py:31-102).  The
reference's naming is crossed and kept: `q2i_attn` attends image -> query.
With ~1900 image tokens both attentions take the plain path by default, as
in JAX; with `models.attention._LONG_SEQ_FUSION` on both go to the fused
kernels' long-sequence regime (and in training draw a dropout seed each
instead of dumped masks).  In training both drop out their probabilities and
fc's output at model.t_dropout (coattention.py:56-65 passes the rate to
both).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ait_tpu_torch.models.attention import MultiHeadAttention
from ait_tpu_torch.models.dropout import Dropout
from ait_tpu_torch.models.layers import Conv, Dense, to_nchw, to_nhwc


class MHACoAttention(nn.Module):
    def __init__(self, channels: int = 1024, n_head: int = 8, d_k: int = 64,
                 d_v: int = 64, dtype=torch.float32):
        super().__init__()
        d = channels // 2
        self.img_emb = Conv(channels, d, 1, dtype=dtype)
        self.qry_emb = Conv(channels, d, 1, dtype=dtype)
        self.q2i_attn = MultiHeadAttention(n_head, d, d_k, d_v, dtype=dtype)
        self.i2q_attn = MultiHeadAttention(n_head, d, d_k, d_v, dtype=dtype)
        self.img_trans = Dense(d, channels, dtype=dtype)
        self.qry_trans = Dense(d, channels, dtype=dtype)

    def forward(self, x_img, x_qry, drop: Optional[Dropout] = None):
        """[B, Hi, Wi, C], [B, Hq, Wq, C] (NHWC) -> the same shapes; drop:
        the training forward's dropout (None at eval)."""
        b, hi, wi, c = x_img.shape
        _, hq, wq, _ = x_qry.shape
        img = to_nhwc(self.img_emb(to_nchw(x_img))).reshape(b, hi * wi, -1)
        qry = to_nhwc(self.qry_emb(to_nchw(x_qry))).reshape(b, hq * wq, -1)
        enc_img = self.q2i_attn(img, qry, qry, drop=drop)
        enc_qry = self.i2q_attn(qry, img, img, drop=drop)
        enc_img = self.img_trans(enc_img)
        enc_qry = self.qry_trans(enc_qry)
        return enc_img.reshape(b, hi, wi, c), enc_qry.reshape(b, hq, wq, c)
