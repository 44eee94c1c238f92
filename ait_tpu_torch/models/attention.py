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
* Under tensor parallelism (`tp_size` > 1 and a tp group) both split over
  the group, Megatron-style: the attention's heads and the FFN's hidden
  units from block slices of the replicated weights (`_tp_forward`, plain
  torch, as the JAX package runs them as plain XLA; parallel/tp.py sums the
  block-sparse gradients).  Under sequence parallelism (`sp_group`,
  inference only, softmax without a mask) the attention shards the image
  tokens of the co-attention: as keys with the exact distributed softmax
  (`sp_role` "kv", parallel/sp.py) or as queries, row-parallel ("q").

In training each module takes the forward's `Dropout` (models/dropout.py)
and asks it for its seed or injected masks in the JAX modules' draw order.

Masks are boolean, True = attend.  Parameters keep the JAX names and
layouts (w_qs/kernel [D, H*d_k], sh/sk/{kernel,bias}, fc/kernel,
LayerNorm_0/{scale,bias}, w_1/{kernel,bias}, w_2/{kernel,bias}).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from ait_tpu_torch.models.dropout import (Dropout, dropping, flax_dropout,
                                          row_dropout)
from ait_tpu_torch.models.layers import (Params, layer_norm_params,
                                         lecun_normal, xavier_uniform,
                                         zeros_init)
from ait_tpu_torch.ops import dropout_masks, fused_attention, fused_ffn
from ait_tpu_torch.ops.fused_attention import layer_norm_f32
from ait_tpu_torch.parallel.mesh import all_gather
from ait_tpu_torch.parallel.sp import pmax_nograd, seq_parallel_attention
from ait_tpu_torch.parallel.tp import replicate_for_tp, tp_allreduce

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
                 dtype=torch.float32, tp_size: int = 1, tp_group=None,
                 sp_group=None, sp_role: str = "kv"):
        super().__init__()
        if n_head < 2:
            raise ValueError("the selective-head gate needs n_head > 1")
        if dist not in ("softmax", "division"):
            raise ValueError(f"attention dist must be 'softmax' or "
                             f"'division', got {dist!r}")
        if tp_size > 1 and (n_head % tp_size or tp_group is None):
            raise ValueError(f"tp_size {tp_size} needs a tp group and must "
                             f"divide n_head ({n_head})")
        if sp_role not in ("kv", "q"):
            raise ValueError(f"sp_role must be 'kv' or 'q', got {sp_role!r}")
        self.n_head, self.d_model, self.d_k, self.d_v = n_head, d_model, d_k, d_v
        self.dist = dist
        self.dtype = dtype
        self.tp_size, self.tp_group = tp_size, tp_group
        self.sp_group, self.sp_role = sp_group, sp_role
        # kernels xavier_uniform, the gate's lecun_normal (attention.py:40,
        # 64-72, 106)
        xavier = xavier_uniform()
        self.w_qs = Params(kernel=((d_model, n_head * d_k), xavier))
        self.w_ks = Params(kernel=((d_model, n_head * d_k), xavier))
        self.w_vs = Params(kernel=((d_model, n_head * d_v), xavier))
        self.sh = nn.ModuleDict({"sk": Params(
            kernel=((d_v, d_v * n_head), lecun_normal()),
            bias=((d_v * n_head,), zeros_init))})
        self.fc = Params(kernel=((d_v, d_model), xavier))
        self.LayerNorm_0 = layer_norm_params(d_model)

    def forward(self, q, k, v, mask=None, drop: Optional[Dropout] = None):
        """drop: the training forward's dropout (None at eval)."""
        b, lq = q.shape[0], q.shape[1]
        lk = k.shape[1]
        dt = self.dtype
        sk = self.sh["sk"]
        ln = self.LayerNorm_0
        dev = q.device
        if self.tp_size > 1:
            return self._tp_forward(q, k, v, mask, drop)
        if self.sp_group is not None:
            if drop is not None:
                raise ValueError("sequence parallelism is an inference-path "
                                 "feature")
            if self.dist != "softmax" or mask is not None:
                raise ValueError("sequence parallelism takes the softmax "
                                 "attention without a mask")
            if self.sp_role == "kv":
                return self._sp_kv_forward(q, k, v)
            return self._sp_q_forward(q, k, v)
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

        attn_keep, out_keep, keep_prob = self._plain_masks(drop, b, lq, lk)
        qh = self._proj(q, self.w_qs.kernel, self.d_k)
        kh = self._proj(k, self.w_ks.kernel, self.d_k)
        vh = self._proj(v, self.w_vs.kernel, self.d_v)
        if mask is not None:
            mask = mask[:, None]                       # head axis
        out = scaled_dot_attention(qh, kh, vh, temperature=self.d_k ** 0.5,
                                   mask=mask, keep=attn_keep,
                                   keep_prob=keep_prob, dist=self.dist)
        return self._out_proj_ln(self._gate(out), q, out_keep, keep_prob)

    def _plain_masks(self, drop, b, lq, lk):
        """(attn_keep [B, H, Tq, Tk], out_keep [B, Tq, D], keep_prob) of the
        plain path: the injected masks, else the dump of a seed's stream;
        (None, None, 1.0) when the site does not draw."""
        if not dropping(drop):
            return None, None, 1.0
        dev = self.fc.kernel.device
        masks = drop.take((b, self.n_head, lq, lk), (b, lq, self.d_model),
                          device=dev)
        if masks is None:
            ak, ok = dropout_masks.dropout_keep_masks(
                drop.seed(dev), b, lq, lk, self.d_model,
                n_head=self.n_head, keep_prob=drop.keep_prob)
            masks = (ak.view(self.n_head, b, lq, lk).transpose(0, 1),
                     ok.view(b, lq, self.d_model))
        return masks[0], masks[1], drop.keep_prob

    def _proj(self, x, w, d, heads=None):
        """[B, T, D] @ w -> [B, H, T, d] per head (heads: the columns' head
        count, n_head unless w is a slice of them)."""
        dt = self.dtype
        y = x.to(dt) @ w.to(dt)
        return y.reshape(x.shape[0], x.shape[1], heads or self.n_head,
                         d).transpose(1, 2)

    def _gate(self, out):
        """SHBlock (SubLayers.py:9-39): the softmax gate over the heads of
        out [B, H, T, d_v] from their token-mean head sum; -> [B, T, d_v]."""
        sk = self.sh["sk"]
        s = out.sum(dim=1).mean(dim=1)                 # [B, d_v]
        gate = s @ sk.kernel.to(s.dtype) + sk.bias.to(s.dtype)
        gate = gate.reshape(out.shape[0], self.n_head, self.d_v)
        gate = torch.softmax(gate.float(), dim=1)
        return (out * gate.to(out.dtype)[:, :, None, :]).sum(dim=1)

    def _out_proj_ln(self, out, residual, out_keep=None, keep_prob=1.0):
        """fc -> dropout -> residual -> post-LN, LN statistics in f32."""
        ln = self.LayerNorm_0
        out = out @ self.fc.kernel.to(out.dtype)
        if out_keep is not None:
            out = flax_dropout(out, out_keep, keep_prob)
        out = out + residual
        return layer_norm_f32(out.float(), ln.scale, ln.bias).to(self.dtype)

    # ---- tensor parallelism (parallel/tp.py) ----------------------------

    def _tp_forward(self, q, k, v, mask, drop):
        """Head-sharded attention over the tp group (attention.py:333-414
        of the JAX package), plain torch as JAX runs it plain: this rank's
        n_head / tp heads from block slices of the replicated weights, the
        SHBlock gate's softmax over ALL heads (a stopped maximum over the
        ranks, a summed denominator), the collapsed head sum all-reduced,
        then fc, dropout, residual and the f32 post-LN replicated.  Dropout
        draws the unsharded model's masks (the same seed and layout) and
        keeps this rank's heads, so a step equals the tp = 1 step on the
        same generator."""
        group = self.tp_group
        n_loc = self.n_head // self.tp_size
        h0 = dist.get_rank(group) * n_loc
        b, lq, lk = q.shape[0], q.shape[1], k.shape[1]
        attn_keep, out_keep, keep_prob = self._plain_masks(drop, b, lq, lk)
        if attn_keep is not None:
            attn_keep = attn_keep[:, h0:h0 + n_loc]

        def head_cols(w, d):
            return w.reshape(w.shape[0], self.n_head, d)[
                :, h0:h0 + n_loc].reshape(w.shape[0], n_loc * d)

        # Megatron's f on the projection inputs (the residual stays plain:
        # its cotangent is already full)
        qh = self._proj(replicate_for_tp(q.to(self.dtype), group),
                        head_cols(self.w_qs.kernel, self.d_k), self.d_k,
                        n_loc)
        kh = self._proj(replicate_for_tp(k.to(self.dtype), group),
                        head_cols(self.w_ks.kernel, self.d_k), self.d_k,
                        n_loc)
        vh = self._proj(replicate_for_tp(v.to(self.dtype), group),
                        head_cols(self.w_vs.kernel, self.d_v), self.d_v,
                        n_loc)
        out = scaled_dot_attention(
            qh, kh, vh, temperature=self.d_k ** 0.5,
            mask=None if mask is None else mask[:, None], keep=attn_keep,
            keep_prob=keep_prob, dist=self.dist)       # [B, n_loc, T, d_v]
        # the gate's input, the token-mean head sum over ALL heads: a sum
        # of the ranks' partials, replicated, feeding rank-local logits
        sk = self.sh["sk"]
        s = replicate_for_tp(tp_allreduce(out.sum(dim=1).mean(dim=1),
                                          group), group)
        skk = sk.kernel.to(s.dtype).reshape(self.d_v, self.n_head, self.d_v)
        skb = sk.bias.to(s.dtype).reshape(self.n_head, self.d_v)
        logits = (torch.einsum("bd,dhe->bhe", s, skk[:, h0:h0 + n_loc]) +
                  skb[h0:h0 + n_loc]).float()
        # the stability shift only: no gradient
        gmax = pmax_nograd(logits.detach().amax(dim=1, keepdim=True), group)
        e = torch.exp(logits - gmax)
        denom = replicate_for_tp(tp_allreduce(e.sum(dim=1, keepdim=True),
                                              group), group)
        gate = e / denom
        out = (out * gate.to(out.dtype)[:, :, None, :]).sum(dim=1)
        out = tp_allreduce(out, group)                 # [B, T, d_v] full
        return self._out_proj_ln(out, q, out_keep, keep_prob)

    # ---- sequence parallelism (inference; parallel/sp.py) ---------------

    def _sp_slice(self, x):
        """This rank's padded token block of a replicated [B, T, D] input:
        (local [B, Tp, D], valid [Tp] bool) with Tp = ceil(T / S)."""
        n = dist.get_world_size(self.sp_group)
        idx = dist.get_rank(self.sp_group)
        t = x.shape[1]
        t_loc = -(-t // n)
        xpad = torch.nn.functional.pad(x, (0, 0, 0, t_loc * n - t))
        local = xpad[:, idx * t_loc:(idx + 1) * t_loc]
        valid = torch.arange(t_loc, device=x.device) + idx * t_loc < t
        return local, valid

    def _sp_kv_forward(self, q, k, v):
        """K/V tokens sharded over the seq group (image tokens as KEYS,
        i2q): each rank projects only its token block, and
        seq_parallel_attention's three all-reduces give the exact softmax;
        the gate, fc, residual and LN see replicated tensors."""
        b, lq = q.shape[0], q.shape[1]
        k_loc, valid = self._sp_slice(k)
        v_loc = k_loc if v is k else self._sp_slice(v)[0]
        qh = self._proj(q, self.w_qs.kernel, self.d_k)
        kh = self._proj(k_loc, self.w_ks.kernel, self.d_k)
        vh = self._proj(v_loc, self.w_vs.kernel, self.d_v)
        mask = valid[None, None, None, :].expand(b, self.n_head, lq,
                                                 valid.shape[0])
        out = seq_parallel_attention(qh, kh, vh, self.sp_group,
                                     scale=1.0 / self.d_k ** 0.5,
                                     mask_shard=mask).to(self.dtype)
        return self._out_proj_ln(self._gate(out), q)

    def _sp_q_forward(self, q, k, v):
        """Query tokens sharded over the seq group (image tokens as
        QUERIES, q2i): each rank attends its token block to the full short
        K/V; the gate's token mean is the one cross-rank sum; the rows come
        home by an all-gather."""
        group = self.sp_group
        b, t = q.shape[0], q.shape[1]
        q_loc, valid = self._sp_slice(q)
        qh = self._proj(q_loc, self.w_qs.kernel, self.d_k)
        kh = self._proj(k, self.w_ks.kernel, self.d_k)
        vh = self._proj(v, self.w_vs.kernel, self.d_v)
        out = scaled_dot_attention(qh, kh, vh, temperature=self.d_k ** 0.5)
        # the gate's mean over all T real tokens (pad rows hold garbage)
        u = torch.where(valid[None, :, None], out.sum(dim=1), 0.0)
        s = tp_allreduce(u.sum(dim=1), group) / t
        sk = self.sh["sk"]
        gate = s @ sk.kernel.to(s.dtype) + sk.bias.to(s.dtype)
        gate = torch.softmax(gate.reshape(b, self.n_head, self.d_v).float(),
                             dim=1)
        out = (out * gate.to(out.dtype)[:, :, None, :]).sum(dim=1)
        out = self._out_proj_ln(out, q_loc.to(out.dtype))
        full = all_gather(out, group)                  # [S, B, Tp, D]
        full = full.transpose(0, 1).reshape(b, -1, out.shape[-1])
        return full[:, :t]


class PositionwiseFeedForward(nn.Module):
    """Post-LN FFN over the last axis, through the fused kernel, with the
    output dropout in training.  With tp_size > 1, Megatron's column/row
    split over the tp group (attention.py:553-582 of the JAX package),
    plain torch as JAX runs it plain: this rank's d_hid / tp hidden units
    from block slices of w_1 and w_2, one all-reduce of the output, then the
    output dropout (the fused kernel's mask of the same seed, so a step
    equals the tp = 1 step), the residual and the f32 post-LN
    replicated."""

    def __init__(self, d_in: int, d_hid: int, dtype=torch.float32,
                 tp_size: int = 1, tp_group=None):
        super().__init__()
        if tp_size > 1 and (d_hid % tp_size or tp_group is None):
            raise ValueError(f"tp_size {tp_size} needs a tp group and must "
                             f"divide d_hid ({d_hid})")
        self.dtype = dtype
        self.tp_size, self.tp_group = tp_size, tp_group
        xavier = xavier_uniform()                 # attention.py:527
        self.w_1 = Params(kernel=((d_in, d_hid), xavier),
                          bias=((d_hid,), zeros_init))
        self.w_2 = Params(kernel=((d_hid, d_in), xavier),
                          bias=((d_in,), zeros_init))
        self.LayerNorm_0 = layer_norm_params(d_in)

    def forward(self, x, drop: Optional[Dropout] = None):
        shape = x.shape
        dt = self.dtype
        flat = x.reshape(-1, shape[-1]).to(dt).contiguous()
        if self.tp_size > 1:
            return self._tp_forward(flat, drop).reshape(shape)
        out = fused_ffn.ffn(flat, self.w_1.kernel.to(dt), self.w_1.bias,
                            self.w_2.kernel.to(dt), self.w_2.bias,
                            self.LayerNorm_0.scale, self.LayerNorm_0.bias,
                            **row_dropout(drop, flat))
        return out.reshape(shape)

    def _tp_forward(self, flat, drop):
        group = self.tp_group
        dt = self.dtype
        h_loc = self.w_1.kernel.shape[1] // self.tp_size
        c0 = dist.get_rank(group) * h_loc
        w1k = self.w_1.kernel.to(dt)[:, c0:c0 + h_loc]
        w1b = self.w_1.bias[c0:c0 + h_loc].to(dt)
        w2k = self.w_2.kernel.to(dt)[c0:c0 + h_loc]
        # Megatron's f on the product's input (the residual stays plain)
        y = torch.relu(replicate_for_tp(flat, group) @ w1k + w1b)
        z = tp_allreduce(y @ w2k, group) + self.w_2.bias.to(dt)
        drop_args = row_dropout(drop, flat)
        if drop_args:
            keep = drop_args.get("keep")
            if keep is None:
                keep = dropout_masks.ffn_keep_mask(
                    drop_args["seed"], *flat.shape,
                    keep_prob=drop_args["keep_prob"])
            z = flax_dropout(z, keep, drop_args["keep_prob"])
        ln = self.LayerNorm_0
        return layer_norm_f32((z + flat).float(), ln.scale, ln.bias).to(dt)
