"""Data layer: datasets, query pools, fixed-shape batch loader, device
prefetch (counterpart of ait_tpu/data)."""

from ait_tpu_torch.data.loader import OneShotLoader
from ait_tpu_torch.data.prefetch import device_prefetch
from ait_tpu_torch.data.records import DatasetView, ImageRecord, QueryExemplar

__all__ = ["OneShotLoader", "DatasetView", "ImageRecord", "QueryExemplar",
           "device_prefetch"]
