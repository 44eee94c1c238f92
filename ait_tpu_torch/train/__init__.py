from ait_tpu_torch.train.optim import (clip_by_global_norm_, lr_schedule,
                                       make_optimizer, param_label, set_lr)
from ait_tpu_torch.train.state import (grads_and_metrics, init_module,
                                       init_params, init_weights,
                                       make_eval_step, make_fused_eval_step,
                                       make_train_step)

__all__ = ["clip_by_global_norm_", "grads_and_metrics", "init_module",
           "init_params", "init_weights", "lr_schedule", "make_eval_step",
           "make_fused_eval_step", "make_optimizer", "make_train_step",
           "param_label", "set_lr"]
