from ait_tpu_torch.evaluation.postprocess import postprocess_detections

__all__ = ["postprocess_detections"]
