"""Evaluation: postprocess, VOC AP, COCO AP, devkit result files
(counterpart of ait_tpu/evaluation)."""
from ait_tpu_torch.evaluation.postprocess import postprocess_detections
from ait_tpu_torch.evaluation.voc_eval import eval_class, evaluate_voc, voc_ap
from ait_tpu_torch.evaluation.voc_results import (comp_id_tag,
                                                  read_experiment_info,
                                                  write_experiment_info,
                                                  write_voc_results_files)

__all__ = ["postprocess_detections", "eval_class", "evaluate_voc", "voc_ap",
           "comp_id_tag", "read_experiment_info", "write_experiment_info",
           "write_voc_results_files"]
