"""Box ops, ROI Align, and the wrappers of the port's CUDA kernels."""

from ait_tpu_torch.ops.nms import batched_nms_topk, nms

__all__ = ["batched_nms_topk", "nms"]
