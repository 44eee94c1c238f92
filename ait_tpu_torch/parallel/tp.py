"""Tensor parallelism over a 'model' mesh axis (counterpart of
ait_tpu/parallel/tp.py).

With cfg.tpu.tp_size > 1 the AIT head's MultiHeadAttention and
PositionwiseFeedForward (models/attention.py) compute the heads and hidden
units of their rank from BLOCK SLICES of the replicated parameters: a rank's
gradient of such a leaf is the full-shape array, zero outside its block, so
a sum over the model axis gives the full gradient.  Every other leaf
(backbone, RPN, fc and LayerNorm tails, embeds) is computed alike on every
model rank, and its local gradient already is the full one.

Megatron's two operators are autograd Functions over the tp group:
`replicate_for_tp` (f: identity forward, all-reduce backward) where a
replicated activation enters rank-local compute, `tp_allreduce` (g:
all-reduce forward, identity backward) where rank partials become a
replicated value.  Torch autograd adds no factor of its own to a
replicated value's cotangent, so neither needs a scale.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.distributed as dist


class _ReplicateForTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _TPAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def replicate_for_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: x unchanged; its cotangent summed over the group (each
    rank's backward carries only its own heads' part)."""
    return _ReplicateForTP.apply(x, group)


def tp_allreduce(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: the sum of x over the group; the replicated cotangent
    passes to every rank's partial unchanged."""
    return _TPAllReduce.apply(x, group)


# parameters whose gradients are block-sparse under tp (models/attention.py):
#   w_qs/w_ks/w_vs kernels      head column blocks
#   sh.sk kernel and bias       per-head gate blocks
#   w_1 kernel and bias, w_2 kernel   the column/row FFN blocks
# (fc, w_2's bias and every LayerNorm see replicated tensors: full grads)
TP_PSUM_SUFFIXES = (
    "w_qs.kernel", "w_ks.kernel", "w_vs.kernel",
    "sh.sk.kernel", "sh.sk.bias",
    "w_1.kernel", "w_1.bias", "w_2.kernel",
)


def is_tp_leaf(name: str) -> bool:
    """Whether the parameter of this dotted name is block-sparse under tp."""
    return any(name == s or name.endswith("." + s) for s in TP_PSUM_SUFFIXES)


def fused_allreduce(tensors: List[torch.Tensor], group,
                    divide: bool = False) -> List[torch.Tensor]:
    """Sum (or with `divide`, average) `tensors` over the group in place,
    through ONE all_reduce per distinct dtype over their flattened
    concatenation; returns them."""
    n = dist.get_world_size(group)
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, group=group)
        if divide:
            flat.div_(n)
        off = 0
        for t in same:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
    return tensors


def tp_psum_grads(model: torch.nn.Module, group) -> None:
    """Sum the block-sparse leaves' .grad over the tp group in place (one
    all_reduce per dtype); every other gradient is already full."""
    grads = [p.grad for name, p in model.named_parameters()
             if p.grad is not None and is_tp_leaf(name)]
    fused_allreduce(grads, group)
