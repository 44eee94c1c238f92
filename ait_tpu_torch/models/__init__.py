from ait_tpu_torch.models.detector import AITDetector, DetectorOut

__all__ = ["AITDetector", "DetectorOut"]
