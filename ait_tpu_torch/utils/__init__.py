"""Shared utilities: logging, metrics, profiling (counterpart of
ait_tpu/utils)."""

from ait_tpu_torch.utils.logging import (AverageMeter, MetricWriter,
                                         ThroughputMeter, color, printer)
from ait_tpu_torch.utils.profiling import annotate, device_trace, timed

__all__ = ["AverageMeter", "MetricWriter", "ThroughputMeter", "color",
           "printer", "annotate", "device_trace", "timed"]
