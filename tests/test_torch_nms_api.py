"""`ait_tpu_torch.ops.nms.nms`, the drop-in for the reference's `_C.nms`,
against ait_tpu.ops.nms.nms on the CPU (the plain sweep): indices and count
equal over seeded boxes with tied scores, counts that are and are not
multiples of the 256-box tile, and `max_out` above and below the number
of survivors.  Its kernel route (csrc/nms.cu, one image) is checked on the
card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ait_tpu.ops import nms as jax_nms
from ait_tpu_torch import ops
from ait_tpu_torch.ops.nms import nms


def _inputs(n, seed, ties):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 200, (n, 2)).astype(np.float32)
    wh = rng.uniform(1, 60, (n, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], 1)
    scores = (rng.randint(0, 12, n) / 12.0 if ties
              else rng.uniform(0, 1, n)).astype(np.float32)
    if ties and n > 3:
        boxes[1] = boxes[0]                  # equal boxes at equal scores
        scores[1] = scores[0]
    return boxes, scores


@pytest.mark.parametrize("n", [1, 7, 256, 300, 513, 1100])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("thresh", [0.3, 0.7])
def test_nms_equals_jax(n, ties, thresh):
    boxes, scores = _inputs(n, n + 7 * ties, ties)
    tb, ts = torch.from_numpy(boxes), torch.from_numpy(scores)
    survivors = int(nms(tb, ts, thresh, n)[1])
    for max_out in (max(survivors // 2, 1), survivors + 5):
        want_idx, want_count = jax_nms(jnp.asarray(boxes),
                                       jnp.asarray(scores), thresh,
                                       max_out=max_out)
        idx, count = nms(tb, ts, thresh, max_out)
        assert idx.shape == (max_out,) and idx.dtype == torch.int64
        assert int(count) == int(want_count), max_out
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx),
                                      err_msg=str(max_out))


def test_nms_of_no_boxes():
    idx, count = nms(torch.zeros((0, 4)), torch.zeros((0,)), 0.5, 4)
    assert int(count) == 0 and idx.tolist() == [-1] * 4


def test_exported():
    assert ops.nms is nms and ops.batched_nms_topk is not None
