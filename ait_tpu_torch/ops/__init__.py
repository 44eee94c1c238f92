"""Box ops, ROI Align, and the wrappers of the port's CUDA kernels."""
