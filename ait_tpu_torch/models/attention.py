"""Attention blocks of the AIT head (counterpart of
ait_tpu/models/attention.py).

* `MultiHeadAttention`: scaled-dot-product attention over 8 heads, the
  SHBlock selective-head gate that collapses the heads into one d_v-wide
  vector, then Linear(d_v -> d_model), residual and post-LayerNorm
  (SubLayers.py:9-102).  Sequences with one shared mask and k is v go to
  the fused kernels (ops/fused_attention.py) in the cases the JAX package
  sends to its Pallas kernel (attention.py:197-226): both sides up to 128
  tokens, and, with the module switch `_LONG_SEQ_FUSION` on, one side up to
  128 and Tq * Tk <= 192 K (the co-attention's ~1900 image tokens against 64
  query tokens).  In training they run the kernels' autograd Function
  (forward with saved per-head outputs, fused backward), with the
  probability and output dropout inside the kernels (drawn from a seed, or
  injected masks), as `fused_sh_attention_rngdrop` does in JAX.
  Everything else (the co-attention by default) takes the plain path below
  and trains by torch autograd, with flax-form dropout on the f32
  probabilities and on fc's output (attention.py:313-316, :171-172), its
  masks drawn by the dump kernel from a seed (ops/dropout_masks.py).
* `PositionwiseFeedForward`: post-LN FFN with output dropout, always through
  the fused kernels (ops/fused_ffn.py), as in the JAX package.

In training each module takes the forward's `Dropout` (models/dropout.py)
and asks it for its seed or injected masks in the JAX modules' draw order.

Masks are boolean, True = attend.  Parameters keep the JAX names and
layouts (w_qs/kernel [D, H*d_k], sh/sk/{kernel,bias}, fc/kernel,
LayerNorm_0/{scale,bias}, w_1/{kernel,bias}, w_2/{kernel,bias}).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ait_tpu_torch.models.dropout import (Dropout, dropping, flax_dropout,
                                          row_dropout)
from ait_tpu_torch.models.layers import Params
from ait_tpu_torch.ops import dropout_masks, fused_attention, fused_ffn
from ait_tpu_torch.ops.fused_attention import layer_norm_f32

# Fuse the long-sequence regime too (one side <= 128 tokens, area <= 192 K:
# the co-attention's two attentions).  A module-level switch with the JAX
# package's name and default (ait_tpu/models/attention.py:49): off, so the
# co-attention takes the plain path unless a caller turns it on.
_LONG_SEQ_FUSION = False


def scaled_dot_attention(q, k, v, *, temperature, mask=None, keep=None,
                         keep_prob=1.0, dist="softmax"):
    """q, k, v: [..., T, d]; mask broadcastable to [..., Tq, Tk].  Logits
    in f32, masked to -1e9, then normalized in f32: softmax, or with
    dist='division' divided by Tk (Modules.py:16-29; the masked logits are
    divided too, as in the reference and the JAX package); flax-form
    dropout on the f32 weights where a keep-mask is given, weights cast to
    v's dtype before P.V."""
    attn = torch.einsum("...qd,...kd->...qk", (q / temperature).float(),
                        k.float())
    if mask is not None:
        attn = torch.where(mask, attn, -1e9)
    if dist == "softmax":
        attn = torch.softmax(attn, dim=-1)
    elif dist == "division":
        attn = attn / attn.shape[-1]
    else:
        raise ValueError(f"attention dist must be 'softmax' or 'division', "
                         f"got {dist!r}")
    if keep is not None:
        attn = flax_dropout(attn, keep, keep_prob)
    out = torch.einsum("...qk,...kd->...qd", attn.to(v.dtype).float(),
                       v.float()).to(v.dtype)
    return out


class MultiHeadAttention(nn.Module):
    """MHA with the selective-head collapse.  dist='division' (attn / Tk in
    place of the softmax) takes the plain path only: the JAX package fuses
    the softmax alone (attention.py:220-224)."""

    def __init__(self, n_head: int = 8, d_model: int = 512, d_k: int = 64,
                 d_v: int = 64, *, dist: str = "softmax",
                 dtype=torch.float32):
        super().__init__()
        if n_head < 2:
            raise ValueError("the selective-head gate needs n_head > 1")
        if dist not in ("softmax", "division"):
            raise ValueError(f"attention dist must be 'softmax' or "
                             f"'division', got {dist!r}")
        self.n_head, self.d_model, self.d_k, self.d_v = n_head, d_model, d_k, d_v
        self.dist = dist
        self.dtype = dtype
        self.w_qs = Params(kernel=(d_model, n_head * d_k))
        self.w_ks = Params(kernel=(d_model, n_head * d_k))
        self.w_vs = Params(kernel=(d_model, n_head * d_v))
        self.sh = nn.ModuleDict({"sk": Params(kernel=(d_v, d_v * n_head),
                                              bias=(d_v * n_head,))})
        self.fc = Params(kernel=(d_v, d_model))
        self.LayerNorm_0 = Params(scale=(d_model,), bias=(d_model,))

    def forward(self, q, k, v, mask=None, drop: Optional[Dropout] = None):
        """drop: the training forward's dropout (None at eval)."""
        b, lq = q.shape[0], q.shape[1]
        lk = k.shape[1]
        dt = self.dtype
        sk = self.sh["sk"]
        ln = self.LayerNorm_0
        dev = q.device
        fusable = fused_attention.fuse_short(lq, lk) or (
            _LONG_SEQ_FUSION and fused_attention.fuse_long(lq, lk))
        fuse = (self.dist == "softmax" and k is v and fusable and
                (mask is None or mask.shape[0] == 1))
        if fuse:
            if mask is None:
                mask2d = torch.ones((lq, lk), dtype=torch.bool, device=dev)
            else:
                mask2d = mask[0].expand(lq, lk).contiguous()
            x_q = q.to(dt).contiguous()
            x_kv = x_q if k is q else k.to(dt).contiguous()
            args = (x_q, x_kv, self.w_qs.kernel.to(dt),
                    self.w_ks.kernel.to(dt), self.w_vs.kernel.to(dt),
                    sk.kernel.to(dt), sk.bias.to(dt), self.fc.kernel.to(dt),
                    ln.scale, ln.bias, mask2d)
            heads = (self.n_head, self.d_k, self.d_v)
            if not dropping(drop):
                return fused_attention.sh_attention(*args, *heads)
            # JAX's order: the probability mask, then the output mask
            masks = drop.take((self.n_head, b * lq, lk),
                              (b * lq, self.d_model), device=dev)
            if masks is not None:
                return fused_attention.fused_sh_attention_dropout(
                    *args, *(m.float() for m in masks), *heads,
                    drop.keep_prob)
            return fused_attention.fused_sh_attention_rngdrop(
                *args, drop.seed(dev), *heads, drop.keep_prob)

        attn_keep = out_keep = None
        keep_prob = drop.keep_prob if dropping(drop) else 1.0
        if dropping(drop):
            masks = drop.take((b, self.n_head, lq, lk), (b, lq, self.d_model),
                              device=dev)
            if masks is None:
                ak, ok = dropout_masks.dropout_keep_masks(
                    drop.seed(dev), b, lq, lk, self.d_model,
                    n_head=self.n_head, keep_prob=keep_prob)
                masks = (ak.view(self.n_head, b, lq, lk).transpose(0, 1),
                         ok.view(b, lq, self.d_model))
            attn_keep, out_keep = masks

        def proj(x, w, d):
            y = x.to(dt) @ w.to(dt)
            return y.reshape(b, x.shape[1], self.n_head, d).transpose(1, 2)

        qh = proj(q, self.w_qs.kernel, self.d_k)
        kh = proj(k, self.w_ks.kernel, self.d_k)
        vh = proj(v, self.w_vs.kernel, self.d_v)
        if mask is not None:
            mask = mask[:, None]                       # head axis
        out = scaled_dot_attention(qh, kh, vh, temperature=self.d_k ** 0.5,
                                   mask=mask, keep=attn_keep,
                                   keep_prob=keep_prob, dist=self.dist)
        # SHBlock gate (SubLayers.py:9-39)
        u = out.sum(dim=1)                             # [B, T, d_v]
        s = u.mean(dim=1)                              # [B, d_v]
        gate = s @ sk.kernel.to(s.dtype) + sk.bias.to(s.dtype)
        gate = gate.reshape(b, self.n_head, self.d_v)
        gate = torch.softmax(gate.float(), dim=1)
        out = (out * gate.to(out.dtype)[:, :, None, :]).sum(dim=1)
        # fc -> dropout -> residual -> post-LN, LN statistics in f32
        out = out @ self.fc.kernel.to(out.dtype)
        if out_keep is not None:
            out = flax_dropout(out, out_keep, keep_prob)
        out = out + q
        return layer_norm_f32(out.float(), ln.scale, ln.bias).to(dt)


class PositionwiseFeedForward(nn.Module):
    """Post-LN FFN over the last axis, through the fused kernel, with the
    output dropout in training."""

    def __init__(self, d_in: int, d_hid: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.w_1 = Params(kernel=(d_in, d_hid), bias=(d_hid,))
        self.w_2 = Params(kernel=(d_hid, d_in), bias=(d_in,))
        self.LayerNorm_0 = Params(scale=(d_in,), bias=(d_in,))

    def forward(self, x, drop: Optional[Dropout] = None):
        shape = x.shape
        dt = self.dtype
        flat = x.reshape(-1, shape[-1]).to(dt).contiguous()
        out = fused_ffn.ffn(flat, self.w_1.kernel.to(dt), self.w_1.bias,
                            self.w_2.kernel.to(dt), self.w_2.bias,
                            self.LayerNorm_0.scale, self.LayerNorm_0.bias,
                            **row_dropout(drop, flat))
        return out.reshape(shape)
