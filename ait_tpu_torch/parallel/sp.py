"""Sequence parallelism: cross-attention with keys and values sharded over
a 'seq' mesh axis (counterpart of ait_tpu/parallel/sp.py).

The co-attention runs 64 query tokens against ~1900 image tokens a pair.
Where the [Tq, Tk] scores or the K/V projections outgrow one device, the
image tokens are sharded: q2i (image tokens as queries) is row-parallel,
and i2q (image tokens as keys) needs a distributed softmax, exact:

    m   = max over ranks( max(scores_r) )     (no gradient: the shift cancels)
    l   = sum over ranks( sum exp(scores_r - m) )
    out = sum over ranks( exp(scores_r - m) @ V_r ) / l

Three all-reduces a call; no [Tq, Tk] tensor crosses ranks.  The two sums
are tp.py's `tp_allreduce` (all-reduce forward, identity backward: each
rank's partial is a true summand of the replicated result), q enters
through `replicate_for_tp` (each rank's backward holds its keys' part of
dq).  The k/v shards need nothing more: torch autograd hands each rank the
replicated output's full cotangent.  (The JAX package scales their
cotangents by S, undoing shard_map's division of a replicated output's
cotangent; torch makes no such division, and the scale would multiply
dk and dv by S.)
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ait_tpu_torch.parallel.mesh import axis_index, axis_size
from ait_tpu_torch.parallel.tp import replicate_for_tp, tp_allreduce


class _MaxNoGrad(torch.autograd.Function):
    """The maximum over the group; a zero gradient (the softmax shift it
    feeds cancels analytically)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g), None


def pmax_nograd(x: torch.Tensor, group) -> torch.Tensor:
    return _MaxNoGrad.apply(x, group)


def shard_seq(x: torch.Tensor, mesh, axis: str = "seq",
              dim: int = -2) -> torch.Tensor:
    """This rank's block of dimension `dim` (the key/value token dim)."""
    n, i = axis_size(mesh, axis), axis_index(mesh, axis)
    t = x.shape[dim]
    if t % n:
        raise ValueError(f"{t} tokens do not split over {n} '{axis}' ranks")
    return x.narrow(dim, i * (t // n), t // n)


def seq_parallel_attention(q: torch.Tensor, k_shard: torch.Tensor,
                           v_shard: torch.Tensor, group, scale: float = 1.0,
                           mask_shard: Optional[torch.Tensor] = None):
    """softmax(q @ k^T * scale) @ v with k/v token-sharded over `group`.

    q [..., Tq, dk] replicated over the group; k_shard/v_shard [..., Tk/S,
    dk|dv] this rank's token block; mask_shard [..., Tq, Tk/S] bool (True
    = attend), this rank's block of the key mask.  Returns [..., Tq, dv],
    the same on every rank.  Differentiable (module docstring)."""
    q = replicate_for_tp(q, group)
    s = torch.einsum("...qd,...kd->...qk", q, k_shard) * scale
    if mask_shard is not None:
        s = torch.where(mask_shard, s, -torch.inf)
    m = pmax_nograd(torch.amax(s, dim=-1), group)
    p = torch.exp(s - m[..., None])
    if mask_shard is not None:
        p = torch.where(mask_shard, p, 0.0)
    l = tp_allreduce(p.sum(dim=-1), group)                    # [..., Tq]
    o = tp_allreduce(torch.einsum("...qk,...kv->...qv", p, v_shard), group)
    return o / l[..., None]
