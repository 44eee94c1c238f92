"""The named device mesh over a torch.distributed world (counterpart of
ait_tpu/parallel/mesh.py), and the collectives the parallel modules share.

One process per device (torchrun, or parallel/launch.py): the mesh is a
`DeviceMesh` (`init_device_mesh`) whose named axes ('data', 'model', 'seq',
'stage') give each rank its coordinate and one process group an axis.  The
LAST axis varies fastest over consecutive ranks, as in the JAX package, so
put the latency-sensitive axis (tp/model) last.

The JAX package's `batch_sharding` and `replicated` return sharding objects
that place one global array; a torch rank holds tensors of its own, so their
counterparts are what the placement does: `shard_batch` returns this rank's
block of rows (the rows a batch sharding puts on it), `replicate` broadcasts
a model or state from the mesh's first rank (a replicated placement).

`all_gather` and `rotate` carry a CUDA tensor through host memory when the
group's backend is gloo, whose all-gather and point-to-point transfers take
host tensors only (several ranks on one card run under gloo, since NCCL
takes one rank a card); under NCCL nothing is staged.  all_reduce and
broadcast run on CUDA tensors under both backends.
"""

from __future__ import annotations

import itertools
import math
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(n_devices: Optional[int] = None,
              axes: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None) -> DeviceMesh:
    """A mesh over the whole initialized world, `shape` ranks per axis (a
    hypercube without it).  A rank cannot sit out of an SPMD program, so
    n_devices, where given, must be the world size."""
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"a mesh of {n} ranks over a world of {world}: "
                         "every rank takes part")
    if shape is None:
        side = round(n ** (1.0 / len(axes)))
        shape = (n,) if len(axes) == 1 else (side,) * len(axes)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes) or math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} over axes {tuple(axes)} does "
                         f"not hold {n} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=tuple(axes))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """Ranks along `axis`; 1 for an axis the mesh does not have."""
    if axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate on `axis` (0 for an axis the mesh lacks)."""
    if axis not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank(axis)


def shard_batch(batch: Any, mesh: DeviceMesh, axis: str = "data") -> Any:
    """This rank's contiguous block of dim 0 of a global batch (a tensor or
    a dict of them) for its coordinate on `axis`; ranks that differ on
    other axes get the same block, and an axis the mesh lacks keeps it
    whole."""
    n, i = axis_size(mesh, axis), axis_index(mesh, axis)

    def block(x):
        rows = x.shape[0]
        if rows % n:
            raise ValueError(f"batch {rows} does not split over {n} "
                             f"'{axis}' ranks")
        return x[i * rows // n:(i + 1) * rows // n]

    if isinstance(batch, dict):
        return {k: block(v) for k, v in batch.items()}
    return block(batch)


def replicate(module_or_state: Any, mesh: DeviceMesh) -> Any:
    """Broadcast every tensor of a module (parameters and buffers) or a dict
    of tensors from the mesh's first rank, in place; returns it."""
    src = int(mesh.mesh.flatten()[0])
    if isinstance(module_or_state, torch.nn.Module):
        tensors = itertools.chain(module_or_state.parameters(),
                                  module_or_state.buffers())
    else:
        tensors = module_or_state.values()
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src)
    return module_or_state


def _staged(group, x: torch.Tensor) -> bool:
    """Whether a host-only gloo collective must carry `x` through host
    memory (module docstring)."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """[S, *x.shape]: every rank's `x` of the group, in group-rank order
    (no gradient)."""
    staged = _staged(group, x)
    src = x.detach().cpu() if staged else x.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.stack(parts)
    return out.to(x.device) if staged else out


def rotate(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Every rank of the group sends `x` to group rank (r + shift) % S and
    returns what (r - shift) % S sent it: a whole-ring rotation, one
    send and one receive a rank (no gradient; pp.py wraps it)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x.clone()
    r = dist.get_rank(group)
    dst = dist.get_global_rank(group, (r + shift) % n)
    src = dist.get_global_rank(group, (r - shift) % n)
    staged = _staged(group, x)
    send = x.detach().cpu() if staged else x.detach().contiguous()
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, dst, group),
                                   dist.P2POp(dist.irecv, recv, src, group)])
    for req in reqs:
        req.wait()
    return recv.to(x.device) if staged else recv
