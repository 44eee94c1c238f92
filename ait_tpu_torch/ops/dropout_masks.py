"""The dropout keep-masks of the port's Philox stream as arrays (counterpart
of ait_tpu/ops/pallas_attention.py:954 dropout_keep_masks and
ait_tpu/ops/pallas_ffn.py:442 ffn_keep_mask, :449 posln_keep_mask).

`keep_mask` is the wrapper of the dump kernel csrc/dropout.cu: f32 0/1
[heads, blocks, length], element e of block (h, i) kept when the stream of
csrc/philox.cuh keeps it.  A CUDA tensor goes to the kernel, a CPU tensor to
the plain version, `philox.keep_mask`.  The three dumps of the JAX package
are its layouts:

* `dropout_keep_masks`: the attention's probability mask [H, P*Tq, Tk]
  (tag 1, a block per head and pair) and output mask [P*Tq, D] (tag 2, a
  block per pair), head-major flat as `_reference_impl` takes them;
* `ffn_keep_mask` and `posln_keep_mask`: [N, D] (tags 3 and 4, a block per
  row).

They check the in-kernel dropout of the fused kernels, and the co-attention's
plain path draws its dropout masks with them (models/attention.py).
`check_seed`, `kernel_keep`, `seed_args` and `count_launch` are the seed and
keep-probability checks and the launch count the fused kernels' wrappers
share.
"""

from __future__ import annotations

import ctypes

import torch

from ait_tpu_torch.ops import _build, philox
from ait_tpu_torch.ops.philox import TAG_ATTN, TAG_FFN, TAG_GLUE, TAG_OUT

_FUNCS = {"keep_mask_dump": [ctypes.c_void_p] + [ctypes.c_int] * 4 +
          [ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p]}


def check_seed(name: str, seed, device) -> None:
    """A site's seed as the kernels read it: int32 [2] on `device`."""
    _build.require(seed is not None and seed.dtype == torch.int32 and
                   tuple(seed.shape) == (2,) and seed.device == device and
                   seed.is_contiguous(),
                   f"{name}: the seed must be a contiguous int32 [2] tensor on "
                   "the operands' device")


def kernel_keep(name: str, keep_prob: float):
    """(threshold, 1 / keep_prob) as the kernels take them."""
    _build.require(0.0 < keep_prob < 1.0,
                   f"{name}: keep_prob must be in (0, 1) with a seed")
    return philox.keep_threshold(keep_prob), 1.0 / keep_prob


def seed_args(name: str, keep_prob: float, seed, device):
    """(seed pointer, threshold, 1 / keep_prob) of a kernel that draws its
    masks from `seed`; (None, 0, 1.0) at keep_prob 1."""
    if keep_prob >= 1.0:
        return None, 0, 1.0
    check_seed(name, seed, device)
    return (seed.data_ptr(),) + kernel_keep(name, keep_prob)


def count_launch(fn, keep_prob: float, regime: str = "") -> None:
    """One launch of `fn`'s kernel: in `fn.launches` at keep_prob 1, else in
    `fn.dropout_launches`; a kernel family of its own (the attention's
    "general_" regime) counts under that prefix."""
    name = regime + ("dropout_launches" if keep_prob < 1.0 else "launches")
    setattr(fn, name, getattr(fn, name) + 1)


def keep_mask(seed: torch.Tensor, tag: int, heads: int, blocks: int,
              length: int, keep_prob: float) -> torch.Tensor:
    """f32 0/1 [heads, blocks, length] of the stream of `seed` ([2] int32)."""
    if seed.device.type == "cpu":
        return philox.keep_mask(seed, tag, heads, blocks, length, keep_prob)
    _build.require(seed.is_cuda, "keep_mask: the kernel runs on CUDA tensors")
    check_seed("keep_mask", seed, seed.device)
    thresh, _ = kernel_keep("keep_mask", keep_prob)
    out = torch.empty((heads, blocks, length), dtype=torch.float32,
                      device=seed.device)
    if out.numel():
        lib = _build.load("dropout", _FUNCS)
        _build.check(lib.keep_mask_dump(
            seed.data_ptr(), tag, heads, blocks, length, thresh,
            out.data_ptr(), _build.stream_ptr(seed.device)), "keep_mask_dump")
        keep_mask.launches += 1
    return out


keep_mask.launches = 0


def dropout_keep_masks(seed, p, tq, tk, d, *, n_head=8, keep_prob=0.9):
    """(attn_keep [H, P*Tq, Tk], out_keep [P*Tq, D]) f32, the masks of the
    attention's in-kernel dropout for P pairs."""
    ak = keep_mask(seed, TAG_ATTN, n_head, p, tq * tk, keep_prob)
    ok = keep_mask(seed, TAG_OUT, 1, p, tq * d, keep_prob)
    return ak.view(n_head, p * tq, tk), ok.view(p * tq, d)


def ffn_keep_mask(seed, n, d, *, keep_prob=0.9):
    """The FFN output dropout's keep-mask [N, D] f32."""
    return keep_mask(seed, TAG_FFN, 1, n, d, keep_prob).view(n, d)


def posln_keep_mask(seed, n, d, *, keep_prob=0.9):
    """The input glue dropout's keep-mask [N, D] f32."""
    return keep_mask(seed, TAG_GLUE, 1, n, d, keep_prob).view(n, d)
