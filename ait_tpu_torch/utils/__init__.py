"""Shared utilities: logging, metrics, profiling (counterpart of
ait_tpu/utils)."""

from ait_tpu_torch.utils.logging import (AverageMeter, MetricWriter,
                                         ThroughputMeter, color, printer)
from ait_tpu_torch.utils.profiling import (annotate, count, device_trace,
                                           recording)

__all__ = ["AverageMeter", "MetricWriter", "ThroughputMeter", "color",
           "printer", "annotate", "count", "device_trace", "recording"]
