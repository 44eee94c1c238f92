"""`ait_tpu_torch.data.device_prefetch`: batches arrive in order and
unchanged, `size` ahead; on the CPU as tensors, on the card through pinned
memory and a side stream (the `gpu` test, run on the card with
`python -m pytest --noconftest -m gpu tests/test_torch_prefetch.py`).
Imports no JAX.
"""

import numpy as np
import pytest
import torch

from ait_tpu_torch.data import device_prefetch


def test_device_prefetch_cpu_order():
    batches = [{"x": np.full((2, 2), i, np.float32),
                "n": np.arange(3, dtype=np.int32) + i} for i in range(7)]
    for size in (1, 3, 10):
        out = list(device_prefetch(iter(batches), size=size, device="cpu"))
        assert len(out) == 7
        for i, b in enumerate(out):
            assert b["x"].dtype == torch.float32 and b["n"].dtype == \
                torch.int32
            np.testing.assert_array_equal(b["x"].numpy(), batches[i]["x"])
            np.testing.assert_array_equal(b["n"].numpy(), batches[i]["n"])
    assert list(device_prefetch(iter([]), device="cpu")) == []
    with pytest.raises(ValueError):
        next(device_prefetch(iter(batches), size=0, device="cpu"))


def test_device_prefetch_needs_a_device_named_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(device_prefetch(iter([{"x": np.zeros(1)}])))


@pytest.mark.gpu
def test_device_prefetch_cuda_bit_equal():
    """On the card: pinned copies on the side stream arrive bit-equal and
    in order, also while the consumer's stream is busy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.RandomState(0)
    batches = [{"image": rng.randint(0, 256, (8, 304, 400, 12)).astype(
        np.uint8), "im_info": rng.rand(8, 3).astype(np.float32)}
        for _ in range(5)]
    busy = torch.randn(4096, 4096, device="cuda")
    for i, b in enumerate(device_prefetch(iter(batches), size=2)):
        busy = busy @ busy / 64.0
        assert b["image"].is_cuda
        for k, v in b.items():
            np.testing.assert_array_equal(v.cpu().numpy(), batches[i][k])
