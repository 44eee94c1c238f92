"""Plain emulation of csrc/sh_attention_general.cu's split sums, in torch.

The tiled attention kernels (the long-sequence and 65-128 token regimes of
`fused_attention`) split the long side of each (head, pair) across blocks
(`fused_attention.general_plan`) and sum across blocks in a fixed order.
This module computes what they compute, in that order, in f32 on any
device, so that the CPU tests hold the decomposition against the plain
versions (`fused_attention.sh_attention_core_reference`,
`sh_attention_bwd_pairs_reference`) and the JAX package's Pallas kernels:

* `split_softmax`: core_fwd + combine, o_h = softmax(s) ak / kp v over key
  splits of 64-key tiles, each split one pass with a running row max m and
  sum l (the accumulated P v rescaled by e^(m_old - m_new) when m grows),
  the splits combined in order, o = sum_s e^(m_s - M) o_s / L;
* `gate_row_sums` / `gate_mean`: the gate's row-sum partials per (64-row
  tile, head), each the sum of the tile's four 16-row quarters in order,
  a quarter's rows in order, and s = (sum over tiles of the sum over heads)
  / Tq, as core_fwd's epilogue, `combine`, `gate_sums` and `gate_kernel`
  take them;
* `split_dz`: core_bwd_q + combine, dz over key splits with the same
  running max, and the row statistics (M, L) core_bwd_kv reads;
* `split_dkv`: core_bwd_kv + reduce_kv, dk and dv summed over the query
  tiles of each q split in order, the splits then in order;
* `general_core_reference` and `general_bwd_pairs_reference`: the forward
  after the projections and the per-pair backward through those, with fc
  and the LayerNorm over 16-row items (LayerNorm and dgate partials per
  item, summed in item order).

Tensors per head are [P, H, T, d] f32; q is already scaled by 1 / sqrt(d_k).
"""

from __future__ import annotations

import torch

from ait_tpu_torch.ops.fused_attention import (GENERAL_ROWS, GENERAL_TILE,
                                               LN_EPS, _heads, _plain_masks,
                                               layer_norm_f32)


def _tiles(n: int, chunk: int, split: int):
    """The 64-row (or key) tiles [start, stop) of split `split` of n rows."""
    t0 = split * chunk * GENERAL_TILE
    t1 = min(n, (split + 1) * chunk * GENERAL_TILE)
    return [(a, min(a + GENERAL_TILE, t1)) for a in range(t0, t1,
                                                          GENERAL_TILE)]


def _scores(qh, kh, mask):
    """The masked scores [P, H, Tq, Tk] (mask False: -1e9)."""
    return torch.where(mask, qh @ kh.transpose(-1, -2),
                       torch.tensor(-1e9, dtype=qh.dtype, device=qh.device))


def _combine(parts):
    """The splits' (m, l, x) in split order: M = max m_s, L = sum_s
    e^(m_s - M) l_s, x = sum_s e^(m_s - M) x_s / L; with one split x / l.
    Returns (x, M, L)."""
    if len(parts) == 1:
        m, l, x = parts[0]
        return x * (1.0 / l), m, l
    big_m = parts[0][0]
    for m, _, _ in parts[1:]:
        big_m = torch.maximum(big_m, m)
    big_l = torch.zeros_like(big_m)
    x = torch.zeros_like(parts[0][2])
    for m, l, xs in parts:
        w = torch.exp(m - big_m)
        big_l = big_l + l * w
        x = x + xs * w
    return x / big_l, big_m, big_l


def _key_pass(scores, step, tk, ksplits, kchunk):
    """One running-max pass per key split: step(p, sl) gives the term that
    the tile of keys `sl` adds (p = e^(s - m) over those keys); returns the
    splits' (m, l, sum of the terms)."""
    parts = []
    for split in range(ksplits):
        m = l = acc = None
        for a, b in _tiles(tk, kchunk, split):
            st = scores[..., a:b]
            mn = st.amax(-1, keepdim=True)
            if m is not None:
                mn = torch.maximum(m, mn)
            p = torch.exp(st - mn)
            term = step(p, slice(a, b))
            if m is None:
                l, acc = p.sum(-1, keepdim=True), term
            else:
                alpha = torch.exp(m - mn)
                l = l * alpha + p.sum(-1, keepdim=True)
                acc = acc * alpha + term
            m = mn
        parts.append((m, l, acc))
    return parts


def split_softmax(qh, kh, vh, mask, ksplits, kchunk, fa=None):
    """o_h [P, H, Tq, d_v] as core_fwd (and combine) compute it; fa: the
    dropout factors ak / kp [P, H, Tq, Tk] or None."""
    scores = _scores(qh, kh, mask)

    def step(p, sl):
        pf = p * fa[..., sl] if fa is not None else p
        return pf @ vh[..., sl, :]

    return _combine(_key_pass(scores, step, kh.shape[-2], ksplits,
                              kchunk))[0]


def gate_row_sums(oh):
    """[P, q tiles, H, d_v]: per 64-row tile and head, the sum of o_h over
    the tile's rows (oh [P, H, Tq, d_v]): each 16-row quarter in row order,
    then the quarters in order."""
    tq = oh.shape[2]
    out = []
    for a in range(0, tq, GENERAL_TILE):
        quarters = []
        for b in range(a, a + GENERAL_TILE, GENERAL_TILE // 4):
            acc = torch.zeros_like(oh[:, :, 0])
            for r in range(b, min(tq, b + GENERAL_TILE // 4)):
                acc = acc + oh[:, :, r]
            quarters.append(acc)
        out.append(((quarters[0] + quarters[1]) + quarters[2]) + quarters[3])
    return torch.stack(out, 1)


def gate_mean(row_sums, tq):
    """s [P, d_v] = (sum over tiles of (sum over heads in order)) / Tq."""
    acc = torch.zeros_like(row_sums[:, 0, 0])
    for t in range(row_sums.shape[1]):
        u = row_sums[:, t, 0]
        for h in range(1, row_sums.shape[2]):
            u = u + row_sums[:, t, h]
        acc = acc + u
    return acc / tq


def split_dz(qh, kh, vh, doh, rd, mask, ksplits, kchunk, fa=None):
    """(dS k [P, H, Tq, d_k] with dS = P (dP ak / kp - rowdot), the row max
    M and sum L [P, H, Tq, 1]) as core_bwd_q (and combine) compute them;
    rd: rowdot [P, H, Tq, 1]."""
    scores = _scores(qh, kh, mask)
    dp = doh @ vh.transpose(-1, -2)
    if fa is not None:
        dp = dp * fa

    def step(p, sl):
        return (p * (dp[..., sl] - rd)) @ kh[..., sl, :]

    return _combine(_key_pass(scores, step, kh.shape[-2], ksplits, kchunk))


def split_dkv(qh, kh, vh, doh, rd, m, l, mask, qsplits, qchunk, fa=None):
    """(dk, dv) [P, H, Tk, d] as core_bwd_kv (and reduce_kv) compute them:
    per q split the query tiles in order, then the splits in order.  m, l:
    the row statistics [P, H, Tq, 1]; dk = dS^T q with q scaled."""
    tq = qh.shape[-2]
    p = torch.exp(_scores(qh, kh, mask) - m) / l
    dp = doh @ vh.transpose(-1, -2)
    pf = p * fa if fa is not None else p
    ds = p * ((dp * fa if fa is not None else dp) - rd)
    dk = dv = None
    for split in range(qsplits):
        sk = sv = None
        for a, b in _tiles(tq, qchunk, split):
            tk_ = ds[..., a:b, :].transpose(-1, -2) @ qh[..., a:b, :]
            tv_ = pf[..., a:b, :].transpose(-1, -2) @ doh[..., a:b, :]
            sk = tk_ if sk is None else sk + tk_
            sv = tv_ if sv is None else sv + tv_
        dk = sk if dk is None else dk + sk
        dv = sv if dv is None else dv + sv
    return dk, dv


def _drop_factors(attn_keep, keep_prob, p, tq, tk, n_head):
    if attn_keep is None:
        return None
    return (attn_keep.float().reshape(n_head, p, tq, tk).transpose(0, 1) *
            (1.0 / keep_prob))


def general_core_reference(q, k, v, sk_w, sk_b, fc_w, x_q, ln_s, ln_b, mask,
                           plan, n_head=8, d_k=64, d_v=64, *, attn_keep=None,
                           out_keep=None, keep_prob=1.0, seed=None,
                           return_oh=False):
    """The general forward after the projections (`project`'s q, k, v) in
    the kernels' decomposition under `plan` (a `GeneralPlan`): same
    arguments and results as `sh_attention_core_reference`."""
    p, tq, d = x_q.shape
    tk = k.shape[0] // p
    dt = x_q.dtype
    attn_keep, out_keep = _plain_masks(attn_keep, out_keep, keep_prob, seed,
                                       p, tq, tk, d, n_head)
    qh = _heads(q, p, tq, n_head, d_k, False) / (d_k ** 0.5)
    kh = _heads(k, p, tk, n_head, d_k, False)
    vh = _heads(v, p, tk, n_head, d_v, False)
    oh = split_softmax(qh, kh, vh, mask, plan.ksplits, plan.kchunk,
                       _drop_factors(attn_keep, keep_prob, p, tq, tk, n_head))
    s = gate_mean(gate_row_sums(oh), tq)
    gate = torch.softmax((s @ sk_w.float() + sk_b.float())
                         .reshape(p, n_head, d_v), dim=1)
    o = oh[:, 0] * gate[:, 0, None, :]
    for h in range(1, n_head):
        o = o + oh[:, h] * gate[:, h, None, :]
    y = o.to(dt).float().reshape(p * tq, d_v) @ fc_w.float()
    if out_keep is not None:
        y = y * out_keep.float() * (1.0 / keep_prob)
    out = layer_norm_f32(y.reshape(p, tq, d) + x_q.float(), ln_s,
                         ln_b).to(dt)
    if not return_oh:
        return out
    return out, oh.transpose(0, 1).reshape(n_head, p * tq, d_v)


def _item_sums(x, p, tq):
    """[P * items, D]: the sums of x [P*Tq, D] over each pair's 16-row
    items, rows in order."""
    out = []
    for pair in range(p):
        for a in range(0, tq, GENERAL_ROWS):
            rows = x[pair * tq + a:pair * tq + min(tq, a + GENERAL_ROWS)]
            acc = rows[0]
            for r in range(1, rows.shape[0]):
                acc = acc + rows[r]
            out.append(acc)
    return torch.stack(out)


def general_bwd_pairs_reference(q, k, v, sk_w, sk_b, fc_w, x_q, ln_s, mask,
                                oh, g, plan, n_head=8, d_k=64, d_v=64, *,
                                qkv_saved=False, attn_keep=None,
                                out_keep=None, keep_prob=1.0, seed=None):
    """The general backward's per-pair part in the kernels' decomposition
    under `plan`: the outputs of `sh_attention_bwd_pairs_reference`, with
    the LayerNorm partials per 16-row item ([2, P * items, D]), the
    arguments as there."""
    p, tq, d = x_q.shape
    tk = k.shape[-2] // p if qkv_saved else k.shape[0] // p
    dt = x_q.dtype
    attn_keep, out_keep = _plain_masks(attn_keep, out_keep, keep_prob, seed,
                                       p, tq, tk, d, n_head)
    ohh = oh.float().reshape(n_head, p, tq, d_v).transpose(0, 1)
    # 1. the gate, rebuilt from the row sums as the forward built it
    s = gate_mean(gate_row_sums(ohh), tq)
    gate = torch.softmax((s @ sk_w.float() + sk_b.float())
                         .reshape(p, n_head, d_v), dim=1)
    o = ohh[:, 0] * gate[:, 0, None, :]
    for h in range(1, n_head):
        o = o + ohh[:, h] * gate[:, h, None, :]
    o = o.reshape(p * tq, d_v).to(dt).float()
    # 2. fc, the output dropout, the residual, the LayerNorm and back
    okf = (out_keep.float() * (1.0 / keep_prob) if out_keep is not None
           else None)
    y0 = o @ fc_w.float()
    y = (y0 * okf if okf is not None else y0) + x_q.reshape(p * tq, d).float()
    mu = y.mean(dim=-1, keepdim=True)
    rs = torch.rsqrt(((y - mu) ** 2).mean(dim=-1, keepdim=True) + LN_EPS)
    xhat = (y - mu) * rs
    g32 = g.reshape(p * tq, d).float()
    lnp = torch.stack([_item_sums(g32 * xhat, p, tq), _item_sums(g32, p, tq)])
    dxhat = g32 * ln_s.float()
    dy = rs * (dxhat - dxhat.mean(dim=-1, keepdim=True) -
               xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
    dy0 = dy * okf if okf is not None else dy
    do = dy0 @ fc_w.float().t()
    # 3. the gate backward: dgate per item, the items in order
    dgp = _item_sums(torch.cat([do * ohh[:, h].reshape(p * tq, d_v)
                                for h in range(n_head)], 1), p, tq)
    items = dgp.shape[0] // p
    dgate = dgp.reshape(p, items, n_head * d_v)
    acc = dgate[:, 0]
    for i in range(1, items):
        acc = acc + dgate[:, i]
    dgate = acc.reshape(p, n_head, d_v)
    gdot = (gate * dgate).sum(dim=1, keepdim=True)
    dlogit = (gate * (dgate - gdot)).reshape(p, n_head * d_v)
    du = (dlogit @ sk_w.float().t()) / tq
    # 4. per head, through the splits
    qh = _heads(q, p, tq, n_head, d_k, qkv_saved)
    if not qkv_saved:
        qh = qh / (d_k ** 0.5)
    kh = _heads(k, p, tk, n_head, d_k, qkv_saved)
    vh = _heads(v, p, tk, n_head, d_v, qkv_saved)
    doh = (do.reshape(p, 1, tq, d_v) * gate[:, :, None, :] +
           du[:, None, None, :])
    rd = (doh * ohh).sum(-1, keepdim=True)
    fa = _drop_factors(attn_keep, keep_prob, p, tq, tk, n_head)
    dz, m, l = split_dz(qh, kh, vh, doh, rd, mask, plan.ksplits, plan.kchunk,
                        fa)
    dk, dv = split_dkv(qh, kh, vh, doh, rd, m, l, mask, plan.qsplits,
                       plan.qchunk, fa)

    def flat(x, t):
        return x.transpose(1, 2).reshape(p * t, -1)

    return (dy, o, s, dlogit, lnp, flat(dz / (d_k ** 0.5), tq), flat(dk, tk),
            flat(dv, tk), dy0)
