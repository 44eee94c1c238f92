"""ait_tpu_torch: the PyTorch/CUDA port of ait_tpu for NVIDIA Hopper.

It mirrors ait_tpu's module layout; every Pallas TPU kernel on a ported path
is a hand-written CUDA kernel here (ait_tpu_torch/csrc), with a plain
PyTorch version beside its wrapper.  The package imports neither JAX nor
ait_tpu.  Entry points run on the GPU unless the caller asks for the CPU.
"""
