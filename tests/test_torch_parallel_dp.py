"""Data parallelism of the port (ait_tpu_torch/parallel/sharded.py) on the
tiny flagship, port against port (the one-process port is held to JAX by
tests/test_torch_train_step.py and its kin), on gloo process groups of the
CPU (parallel/launch.py, one intra-op thread a rank):

* on a one-rank 'data' mesh, two steps of make_sharded_train_step at
  t_dropout 0.1 are bit-equal to make_train_step from the same weights and
  generator (losses and every parameter after each step), and the sharded
  eval step to make_eval_step;
* dp2 (1 image a rank, t_dropout 0.1): every rank's parameters bitwise
  equal after the step; its one `ait:allreduce` span a rank, with the bytes
  reduced counted; the reduced gradients within 1e-6 of each leaf's
  max |plain| of the mean of grads_and_metrics on each half under that
  half's derived generator (computed on rank 0), the losses the mean and
  fg_cnt / bg_cnt the sums of the halves';
* the dp2 sharded eval step equal to eval of each image alone.
"""

import numpy as np
import pytest

import torch_parallel_workers as workers


@pytest.fixture(scope="module")
def dp2():
    return workers.run(workers.dp2, 2)


def test_world1_sharded_steps_bit_equal_plain():
    (same,) = workers.run(workers.dp_world1, 1)
    assert same == [(True, True)] * 3


def test_dp2_params_replicated(dp2):
    digests = dp2[0][0]
    assert len(digests) == 2 and digests[0] == digests[1]


def test_dp2_grads_are_the_mean_of_the_halves(dp2):
    errs, _, _, same_leaves = dp2[0][1]
    assert same_leaves and len(errs) > 100
    bad = {k: e for k, e in errs.items() if e > 1e-6}
    assert not bad, bad


def test_dp2_metrics_mean_losses_and_sum_counts(dp2):
    _, counts, losses, _ = dp2[0][1]
    for k, (got, want) in counts.items():
        assert got == want, k
    assert counts["fg_cnt"][0] + counts["bg_cnt"][0] == 2 * 8
    for k, (got, want) in losses.items():
        assert np.isfinite(got) and abs(got - want) <= 1e-6 * abs(want), k


def test_dp2_records_one_allreduce_span_a_step(dp2):
    """Each rank's step records `ait:allreduce` once, its `allreduce.bytes`
    the bytes of the gradients and metrics it reduces."""
    for rank in range(2):
        spans, reduced = dp2[rank][2]
        got = [counts for name, counts in spans if name == "ait:allreduce"]
        assert got == [{"allreduce.bytes": reduced}], spans
        assert reduced > 4 * 10 ** 6


def test_dp2_eval_equals_eval_of_each_image():
    parts, alone = workers.run(workers.dp2_eval, 2)[0]
    for part, one in zip(parts, alone):
        assert sorted(part) == ["bbox_pred", "cls_prob", "rois"]
        for k in part:
            np.testing.assert_array_equal(part[k], one[k], err_msg=k)
