"""Data-parallel train and eval steps over a 'data' mesh axis (counterpart
of ait_tpu/parallel/sharded.py).

Every rank runs the whole step, the kernels included, on its own rows of
the global batch (the rows `shard_batch` or the loader's `process_index`
give it), then ONE `fused_pmean` of the gradients and the metrics per dtype
(the span `ait:allreduce`, its bytes counted as `allreduce.bytes`),
where the reference's DataParallel gathered and meaned the losses
(trainval_net_voc.py:391-395).  Not one all-reduce a leaf (154 for the
flagship), and not DDP's buckets: the single reduction keeps the JAX
package's numerics (the same addends, the same mean over n), makes a
one-rank step bitwise the plain step, and composes with the tp sum.

Randomness: at a data size n > 1 each data rank draws from a generator
seeded by one draw of the caller's generator and its DATA index (never its
tp index: dropout and sampling act on tensors replicated over the model
axis), so the shards decorrelate and the caller's generator advances alike
on every rank.  At n = 1 the caller's generator is used untouched, which
makes the step bit-equal to `train.make_train_step` on the same generator.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from ait_tpu_torch.device import resolve_device
from ait_tpu_torch.parallel.mesh import axis_index, axis_size
from ait_tpu_torch.parallel.tp import fused_allreduce, tp_psum_grads
from ait_tpu_torch.train.state import (apply_update, check_generator,
                                       grads_and_metrics, make_eval_step)
from ait_tpu_torch.utils.profiling import annotate, count, is_recording

# golden-ratio stride between the data ranks' seeds
_SEED_STRIDE = 0x9E3779B97F4A7C15


def fused_pmean(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """Average `tensors` over the group in place: one all_reduce (SUM, then
    a division by the group size) per distinct dtype over the flattened,
    concatenated tensors; returns them."""
    return fused_allreduce(tensors, group, divide=True)


def shard_generator(generator: torch.Generator,
                    index: int) -> torch.Generator:
    """The generator of data rank `index`: one draw of `generator` (on its
    device) and the index seed it."""
    draw = int(torch.randint(0, 2 ** 62, (), generator=generator,
                             device=generator.device))
    seed = (draw + index * _SEED_STRIDE) % 2 ** 63
    return torch.Generator(device=generator.device).manual_seed(seed)


def make_sharded_train_step(model, optimizer: torch.optim.Optimizer,
                            schedule: Callable[[int], float], mesh, *,
                            axis: str = "data", tp_axis: Optional[str] = None,
                            accum_steps: int = 1, device=None,
                            start_step: int = 0) -> Callable:
    """train_step(batch, generator) -> metrics over `mesh` (module
    docstring); batch holds this rank's rows.  With `tp_axis` (the model
    built with that axis's size as cfg.tpu.tp_size) the rows are the same on
    every rank of the axis, the heads and hidden units are rank-local, and
    the block-sparse gradients are summed over it (parallel/tp.py) before
    the data mean.  fg_cnt and bg_cnt come out as sums over the data ranks,
    every other metric as the mean.  The model moves to `device` (the GPU
    unless named); `train_step.step` counts steps as in make_train_step."""
    dev = resolve_device(device)
    model.to(dev).train()
    n = axis_size(mesh, axis)
    index = axis_index(mesh, axis)
    group = mesh.get_group(axis) if n > 1 else None
    tp_group = (mesh.get_group(tp_axis)
                if tp_axis is not None and axis_size(mesh, tp_axis) > 1
                else None)
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def train_step(batch: Dict[str, torch.Tensor],
                   generator: torch.Generator) -> Dict[str, torch.Tensor]:
        check_generator(generator)
        optimizer.zero_grad(set_to_none=True)
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        if n > 1:
            generator = shard_generator(generator, index)
        metrics = grads_and_metrics(model, batch, generator, accum_steps)
        if tp_group is not None:
            tp_psum_grads(model, tp_group)
        if n > 1:
            # counts are sums over the shards: f32 (exact below 2^24),
            # pre-multiplied by n so that the mean below gives the sum
            for k in ("fg_cnt", "bg_cnt"):
                metrics[k] = metrics[k].float() * n
            metrics = {k: v.float().clone() for k, v in metrics.items()}
            grads = [p.grad for p in model.parameters()
                     if p.grad is not None]
            reduced = grads + list(metrics.values())
            with annotate("ait:allreduce"):
                if is_recording():
                    count("allreduce.bytes", sum(
                        t.numel() * t.element_size() for t in reduced))
                fused_pmean(reduced, group)
        apply_update(optimizer, params, schedule(train_step.step))
        train_step.step += 1
        return metrics

    train_step.step = int(start_step)
    return train_step


def make_sharded_eval_step(model, mesh, axis: str = "data") -> Callable:
    """eval_step(batch) -> {'rois', 'cls_prob', 'bbox_pred'} of this rank's
    rows (the JAX step's out_specs=P(axis) block), batch holding this
    rank's rows on the model's device.  A data rank needs no collective;
    a model built on the mesh's seq axis runs its co-attention's
    collectives inside the forward."""
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"the mesh has no '{axis}' axis")
    return make_eval_step(model)
