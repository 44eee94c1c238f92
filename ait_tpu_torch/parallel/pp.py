"""Pipeline parallelism: GPipe microbatch pipelining over a 'stage' mesh
axis (counterpart of ait_tpu/parallel/pp.py).

A chain of S same-shaped stages, one a rank, streams M microbatches: stage
s works on microbatch m while stage s+1 works on m-1, over M + S - 1 ticks
(bubble (S-1)/(M+S-1)).  Each rank holds only its stage's parameters
(`shard_stage_params` of the stacked [S, ...] leaves).

SPMD, as in the JAX package: every rank runs the same tick loop and makes
the same transfers, each a whole-ring rotation (`ppermute`, an autograd
Function on `dist.batch_isend_irecv` whose backward is the reverse
rotation), and every choice between a received and a local value is a
tensor select, never a Python branch on the rank.  So the autograd graph
has the same shape on every rank, and backward issues the matching
rotations in the same order everywhere: the schedule is differentiable
without one-sided sends inside autograd.

The stream is padded to a multiple of S, and each rank owns a contiguous
block of mb = ceil(M / S) microbatches in and out:
  * inputs ride a DELIVERY ring one hop toward stage 0 a tick, holding
    "the slot at rank d on tick t carries microbatch t + d": a rank
    overwrites its slot with its own copy when that microbatch is in its
    block, and stage 0 consumes microbatch t on time;
  * outputs ride a RETURN ring the same way: stage S-1 injects each
    finished microbatch, the slot passing rank d on tick t carries
    microbatch t - 2S + 2 + d, and its home rank (micro // mb) keeps it.
Three single-microbatch rotations a tick, each a neighbour exchange.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from ait_tpu_torch.parallel.mesh import axis_index, axis_size, rotate


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return rotate(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return rotate(g.contiguous(), ctx.group, -ctx.shift), None, None


def ppermute(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Send x to group rank (r + shift) % S, receive from (r - shift) % S;
    differentiable (the cotangent takes the reverse rotation)."""
    return _PPermute.apply(x, group, shift)


def stack_stage_params(per_stage: List[Dict[str, torch.Tensor]]
                       ) -> Dict[str, torch.Tensor]:
    """[state_dict of stage 0, of stage 1, ...] -> {name: [S, ...]}: the
    stages share one parameter structure."""
    return {k: torch.stack([sd[k] for sd in per_stage])
            for k in per_stage[0]}


def shard_stage_params(stacked: Dict[str, torch.Tensor], mesh,
                       axis: str = "stage") -> Dict[str, torch.Tensor]:
    """This rank's stage of [S, ...] leaves: only 1/S of the model stays."""
    i = axis_index(mesh, axis)
    return {k: v[i].clone() for k, v in stacked.items()}


def make_pipeline_apply(fn: Callable, mesh, n_microbatches: int,
                        axis: str = "stage") -> Callable:
    """pipelined(stage_params, x) -> this rank's block of outputs.

    `fn(stage_params, x) -> y`: one stage, the same shapes in and out for
    every stage.  `stage_params`: this rank's stage (shard_stage_params, or
    any object fn takes).  `x`: the whole stream [M, ...] of M
    microbatches, the same on every rank; the rank keeps its block.
    Returns the outputs of stage S-1 for this rank's block of microbatches
    ([mb, ...], the padding cut from the last block): the blocks of ranks
    0..S-1 in order are the M outputs."""
    n_stages = axis_size(mesh, axis)
    stage = axis_index(mesh, axis)
    group = mesh.get_group(axis)
    m = int(n_microbatches)
    mb = -(-m // n_stages)
    m_pad = mb * n_stages
    last = n_stages - 1

    def pipelined(stage_params, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] != m:
            raise ValueError(f"the stream holds {x.shape[0]} microbatches, "
                             f"the pipeline was made for {m}")
        if m_pad > m:
            x = torch.cat([x, x.new_zeros((m_pad - m,) + x.shape[1:])])
        block = x[stage * mb:(stage + 1) * mb]
        zero = x.new_zeros(x.shape[1:])

        def flag(cond: bool) -> torch.Tensor:
            return torch.tensor(cond, device=x.device)

        recv = inflight = outflight = zero
        outs = [zero] * mb
        for t in range(m_pad + n_stages - 1):
            # delivery ring: rank d holds micro t + d
            din = t + stage
            own = flag(din // mb == stage)
            mine = block[min(max(din - stage * mb, 0), mb - 1)]
            inflight = torch.where(own, mine, ppermute(inflight, group, -1))
            # stage 0 consumes the ring's head, the others their neighbour's
            # output of the last tick
            out = fn(stage_params, torch.where(flag(stage == 0), inflight,
                                               recv))
            recv = ppermute(out, group, 1)
            # return ring: stage S-1 injects micro t - (S-1)
            outflight = torch.where(flag(stage == last), out,
                                    ppermute(outflight, group, -1))
            micro = t - (2 * n_stages - 2) + stage
            slot = min(max(micro - stage * mb, 0), mb - 1)
            keep = flag(0 <= micro < m_pad and micro // mb == stage)
            outs[slot] = torch.where(keep, outflight, outs[slot])
        y = torch.stack(outs)
        return y[:max(0, min(mb, m - stage * mb))]

    return pipelined
