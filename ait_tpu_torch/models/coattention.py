"""Image <-> query co-attention, both flavors (counterpart of
ait_tpu/models/coattention.py).

`MHACoAttention`, the VOC model's: a 1x1-conv embed to 512, a pair of cross MultiHeadAttentions, and a linear
map back to 1024 (faster_rcnn_sys_transformer_sk_dilat.py:31-102).  The
reference's naming is crossed and kept: `q2i_attn` attends image -> query.
With ~1900 image tokens both attentions take the plain path by default, as
in JAX; with `models.attention._LONG_SEQ_FUSION` on both go to the fused
kernels' long-sequence regime (and in training draw a dropout seed each
instead of dumped masks).  In training both drop out their probabilities and
fc's output at model.t_dropout (coattention.py:56-65 passes the rate to
both).

`NonLocalCoAttention`, the COCO model's (coattention.py:72-137): one shared
1x1 embed, a bilinear relation between the query's `rho` and the image's
`phi` embeddings normalized by 'division' (by the other side's token count)
or 'softmax', each side's relation-weighted sum of the other side's
embedding, then a 1x1 conv to `channels` and a zero-initialised GroupNorm
(so the branch starts as the identity) added to the input.  The relation's
products run on f32 operands (bf16 values are exact in f32; JAX multiplies
with preferred_element_type f32), the normalized relation is cast to the
embedding dtype before the second products, and the GroupNorm gives f32, so
the outputs are f32 under bf16 compute, as flax promotes them.  No dropout.
The sequence-parallel relation (sp_axis) is ROADMAP A15.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ait_tpu_torch.models.attention import MultiHeadAttention
from ait_tpu_torch.models.dropout import Dropout
from ait_tpu_torch.models.layers import (Conv, Dense, ZeroInitGroupNorm,
                                         to_nchw, to_nhwc)


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


class NonLocalCoAttention(nn.Module):
    def __init__(self, channels: int = 1024, normalization: str = "division",
                 dtype=torch.float32):
        super().__init__()
        if normalization not in ("division", "softmax"):
            raise ValueError(f"coatt_normalization {normalization}")
        d = channels // 2
        self.emb = Conv(channels, d, 1, dtype=dtype)
        self.rho = Conv(channels, d, 1, dtype=dtype)
        self.phi = Conv(channels, d, 1, dtype=dtype)
        self.theta_conv = Conv(d, channels, 1, dtype=dtype)
        self.theta_gn = ZeroInitGroupNorm(channels)
        self.omega_conv = Conv(d, channels, 1, dtype=dtype)
        self.omega_gn = ZeroInitGroupNorm(channels)
        self.normalization = normalization
        self.dtype = dtype

    def _relation(self, emb_img, emb_qry, rho_qry, phi_img):
        """(non_img [B, Ni, d], non_qry [B, Nq, d]) f32 (coattention.py
        :118-137)."""
        rel = torch.matmul(rho_qry.float(), phi_img.float().transpose(1, 2))
        n_q, n_i = rel.shape[1], rel.shape[2]
        rel_t = rel.transpose(1, 2)
        if self.normalization == "softmax":
            q2i = torch.softmax(rel, dim=2)
            i2q = torch.softmax(rel_t, dim=2)
        else:
            q2i = rel / n_i
            i2q = rel_t / n_q
        q2i = q2i.to(emb_img.dtype).float()
        i2q = i2q.to(emb_img.dtype).float()
        non_img = torch.matmul(i2q, emb_qry.float())
        non_qry = torch.matmul(q2i, emb_img.float())
        return non_img, non_qry

    def forward(self, x_img, x_qry, drop: Optional[Dropout] = None):
        """[B, Hi, Wi, C], [B, Hq, Wq, C] (NHWC) -> the same shapes, f32;
        drop is unused (no dropout in this flavor)."""
        del drop
        b, hi, wi, c = x_img.shape
        _, hq, wq, _ = x_qry.shape
        img, qry = to_nchw(x_img), to_nchw(x_qry)
        emb_img = to_nhwc(self.emb(img)).reshape(b, hi * wi, -1)
        emb_qry = to_nhwc(self.emb(qry)).reshape(b, hq * wq, -1)
        rho_qry = to_nhwc(self.rho(qry)).reshape(b, hq * wq, -1)
        phi_img = to_nhwc(self.phi(img)).reshape(b, hi * wi, -1)
        non_img, non_qry = self._relation(emb_img, emb_qry, rho_qry, phi_img)
        d = non_img.shape[-1]
        non_img = non_img.to(self.dtype).reshape(b, hi, wi, d)
        non_img = self.theta_gn(to_nhwc(self.theta_conv(to_nchw(non_img))))
        non_qry = non_qry.to(self.dtype).reshape(b, hq, wq, d)
        non_qry = self.omega_gn(to_nhwc(self.omega_conv(to_nchw(non_qry))))
        return non_img + x_img, non_qry + x_qry
