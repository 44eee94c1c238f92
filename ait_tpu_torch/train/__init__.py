from ait_tpu_torch.train.optim import (lr_schedule, make_optimizer,
                                       param_label, set_lr)
from ait_tpu_torch.train.state import (grads_and_metrics, make_eval_step,
                                       make_train_step)

__all__ = ["grads_and_metrics", "lr_schedule", "make_eval_step",
           "make_optimizer", "make_train_step", "param_label", "set_lr"]
