"""The Adaptive Image Transformer (counterpart of
ait_tpu/models/ait_transformer.py).

* enc_emb/dec_emb: 1x1-conv embed 1024 -> 512;
* the proposal tokens (7x7 = 49) are zero-padded to 56 with a pad mask over
  the keys: the reference pads to 64, but pad outputs are never consumed,
  so the JAX package runs the encoder at the 8-aligned 56 (exact up to the
  order of f32 sums);
* sinusoidal positions + dropout + input LayerNorm through the fused glue
  kernel;
* encoder = n_layers x (self-attention + FFN) over proposal tokens; decoder
  = n_layers x (causal self-attention + cross-attention to the encoder +
  FFN) over query tokens;
* the decoder input is the query repeated per proposal (`repeat_interleave`,
  image rows stay contiguous).  At eval, and in training with
  `dec_prefix_per_image` (the config's default), the repeat is deferred to
  the first cross-attention: the prefix (glue, first self-attention) runs
  once per image, and each image's proposals share its prefix dropout
  masks.  In training without it the query is repeated up front, as the
  reference does, and every proposal draws its own prefix masks
  (ait_transformer.py:146-154);
* the output goes back to the query grid and through a 1x1 conv to 1024.

In training every site draws from the forward's `Dropout` in the JAX
module's order (glue, then each layer's attentions and FFN).  Feature maps
are NHWC, tokens [N, T, C].
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ait_tpu_torch.models.attention import (MultiHeadAttention,
                                            PositionwiseFeedForward)
from ait_tpu_torch.models.dropout import Dropout, row_dropout
from ait_tpu_torch.models.layers import (Conv, Params, sinusoid_table,
                                         to_nchw, to_nhwc)
from ait_tpu_torch.ops import fused_ffn


class EncoderLayer(nn.Module):
    def __init__(self, d_model, d_inner, n_head, d_k, d_v,
                 dtype=torch.float32):
        super().__init__()
        self.slf_attn = MultiHeadAttention(n_head, d_model, d_k, d_v,
                                           dtype=dtype)
        self.pos_ffn = PositionwiseFeedForward(d_model, d_inner, dtype)

    def forward(self, x, mask, drop: Optional[Dropout] = None):
        return self.pos_ffn(self.slf_attn(x, x, x, mask, drop=drop), drop)


class DecoderLayer(nn.Module):
    def __init__(self, d_model, d_inner, n_head, d_k, d_v,
                 dtype=torch.float32):
        super().__init__()
        self.slf_attn = MultiHeadAttention(n_head, d_model, d_k, d_v,
                                           dtype=dtype)
        self.enc_attn = MultiHeadAttention(n_head, d_model, d_k, d_v,
                                           dtype=dtype)
        self.pos_ffn = PositionwiseFeedForward(d_model, d_inner, dtype)

    def forward(self, x, enc_out, slf_mask, cross_mask, repeat: int = 1,
                drop: Optional[Dropout] = None):
        x = self.slf_attn(x, x, x, slf_mask, drop=drop)
        if repeat > 1:
            x = torch.repeat_interleave(x, repeat, dim=0)
        x = self.enc_attn(x, enc_out, enc_out, cross_mask, drop=drop)
        return self.pos_ffn(x, drop)


class AITTransformer(nn.Module):
    """[BP, hp, wp, C] proposals x [B, hq, wq, C] query -> [BP, hq, wq, C]."""

    def __init__(self, d_model: int = 512, d_inner: int = 2048,
                 n_layers: int = 1, n_head: int = 8, d_k: int = 64,
                 d_v: int = 64, n_position: int = 64,
                 causal_mask: bool = True, channels: int = 1024,
                 dec_prefix_per_image: bool = True, dtype=torch.float32):
        super().__init__()
        self.d_model, self.n_layers, self.dtype = d_model, n_layers, dtype
        self.causal_mask = causal_mask
        self.dec_prefix_per_image = dec_prefix_per_image
        self.enc_emb = Conv(channels, d_model, 1, dtype=dtype)
        self.dec_emb = Conv(channels, d_model, 1, dtype=dtype)
        self.enc_in_ln = Params(scale=(d_model,), bias=(d_model,))
        self.dec_in_ln = Params(scale=(d_model,), bias=(d_model,))
        for i in range(n_layers):
            self.add_module(f"enc_layer{i}", EncoderLayer(
                d_model, d_inner, n_head, d_k, d_v, dtype))
            self.add_module(f"dec_layer{i}", DecoderLayer(
                d_model, d_inner, n_head, d_k, d_v, dtype))
        self.dec_trans = Conv(d_model, channels, 1, dtype=dtype)
        self.register_buffer(
            "pos", torch.from_numpy(sinusoid_table(n_position, d_model)),
            persistent=False)

    def _in_glue(self, x_seq, ln, drop):
        """LayerNorm(dropout(x + pos)) over flat pair-major rows (fused
        kernel)."""
        flat = x_seq.reshape(-1, self.d_model).to(self.dtype).contiguous()
        pos = self.pos[:x_seq.shape[1]].to(self.dtype).contiguous()
        return fused_ffn.posln(flat, pos, ln.scale, ln.bias,
                               **row_dropout(drop, flat)).reshape(
                                   x_seq.shape)

    def forward(self, x_props, x_query, drop: Optional[Dropout] = None):
        """drop: the training forward's dropout (None at eval)."""
        bp, hp, wp, _ = x_props.shape
        bs, hq, wq, _ = x_query.shape
        num_props = bp // bs
        d = self.d_model
        src = to_nhwc(self.enc_emb(to_nchw(x_props))).reshape(bp, hp * wp, d)
        trg = to_nhwc(self.dec_emb(to_nchw(x_query))).reshape(bs, hq * wq, d)
        # the repeat per proposal: deferred into the first decoder layer at
        # eval and with the per-image prefix, else up front
        dec_repeat = num_props if (
            num_props > 1 and (drop is None or self.dec_prefix_per_image)
        ) else 1
        if dec_repeat == 1:
            trg = torch.repeat_interleave(trg, num_props, dim=0)

        n_s, n_t = src.shape[1], trg.shape[1]
        n_enc = min(n_t, -(-n_s // 8) * 8)
        src = torch.nn.functional.pad(src, (0, 0, 0, n_enc - n_s))
        dev = src.device
        src_mask = (torch.arange(n_enc, device=dev) < n_s)[None, None, :]
        if self.causal_mask:
            trg_mask = torch.tril(torch.ones((n_t, n_t), dtype=torch.bool,
                                             device=dev))[None]
        else:
            trg_mask = torch.ones((1, n_t, n_t), dtype=torch.bool, device=dev)

        enc = self._in_glue(src, self.enc_in_ln, drop)
        for i in range(self.n_layers):
            enc = getattr(self, f"enc_layer{i}")(enc, src_mask, drop)
        dec = self._in_glue(trg, self.dec_in_ln, drop)
        for i in range(self.n_layers):
            dec = getattr(self, f"dec_layer{i}")(
                dec, enc, trg_mask, src_mask,
                repeat=dec_repeat if i == 0 else 1, drop=drop)
        out = dec.reshape(bp, hq, wq, d)
        return to_nhwc(self.dec_trans(to_nchw(out)))
