"""The parallel families (counterpart of ait_tpu/parallel): data-parallel
train and eval steps over a 'data' mesh axis (sharded.py), Megatron tensor
parallelism over a 'model' axis (tp.py), sequence-parallel cross-attention
over a 'seq' axis (sp.py), the GPipe pipeline over a 'stage' axis (pp.py),
the mesh (mesh.py), the multi-process CLIs' glue (multihost.py), and local
multi-process runs (launch.py).  One process a device, over
torch.distributed.

The names load on first use: the model modules import tp.py and sp.py,
and sharded.py imports the train step, which imports the models.
"""

import importlib

_EXPORTS = {
    "mesh": ("make_mesh", "replicate", "shard_batch"),
    "multihost": ("allgather_object", "host_local_rows",
                  "maybe_init_distributed", "merge_all_boxes"),
    "pp": ("make_pipeline_apply", "shard_stage_params",
           "stack_stage_params"),
    "sp": ("seq_parallel_attention", "shard_seq"),
    "sharded": ("fused_pmean", "make_sharded_eval_step",
                "make_sharded_train_step"),
    "tp": ("replicate_for_tp", "tp_allreduce", "tp_psum_grads"),
}
_WHERE = {name: mod for mod, names in _EXPORTS.items() for name in names}

__all__ = sorted(_WHERE)


def __getattr__(name):
    if name not in _WHERE:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_WHERE[name]}"),
                   name)
