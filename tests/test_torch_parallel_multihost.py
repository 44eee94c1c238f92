"""The port's multi-process glue (ait_tpu_torch/parallel/launch.py,
multihost.py, mesh.py, sharded.fused_pmean) and the multi-process CLIs, on
gloo process groups of the CPU.

* `run_local`: results in rank order, one intra-op thread a rank, a rank's
  exception re-raised with its rank, every child killed at the timeout
  (a rank that never enters a collective), three calls at once from
  threads each in a group of its own;
* `allgather_object` + `merge_all_boxes`, the latter against the JAX
  package's; `maybe_init_distributed` from torchrun's environment (gloo,
  in a subprocess) and without it; the (data x model) mesh's coordinates
  (the last axis fastest), `shard_batch`'s blocks and `replicate`;
* `fused_pmean` over 4 ranks against the JAX package's on its virtual
  mesh, in one all_reduce;
* the train CLI on 2 ranks (2 steps of 2 images a rank, one checkpoint:
  one state.pt and config.json, rank 0's metrics alone), and the eval CLI
  on 2 ranks, whose merged detections hold every pair once and equal the
  one-process run's (1 pair a batch on both sides) within 1e-3;
* the world sizes the CLIs refuse, with the sizes that would work.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_parallel_workers as workers
from fixtures import make_voc_devkit
from ait_tpu.parallel import make_mesh
from ait_tpu.parallel.multihost import merge_all_boxes as jax_merge
from ait_tpu.parallel.sharded import fused_pmean as jax_fused_pmean
from ait_tpu.parallel.sharded import shard_map
from ait_tpu_torch.data.coco import read_data_pickle
from ait_tpu_torch.parallel import multihost
from ait_tpu_torch.tools import test_net, trainval_net

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


N = 4
LEAVES = [[np.random.RandomState(r).randn(*shape).astype(np.float32)
           for shape in ((3, 5), (7,), (4, 2))] for r in range(N)]


@pytest.fixture(scope="module")
def four():
    """One world of N ranks for the glue's checks (workers.glue)."""
    return workers.run(workers.glue, N, LEAVES)


def test_run_local_returns_in_rank_order(four):
    assert [r["rank_world"] for r in four] == [(r, N, "cpu", 1)
                                               for r in range(N)]


def test_run_local_reraises_with_the_rank():
    with pytest.raises(RuntimeError,
                       match="(?s)rank 1 raised.*boom on rank 1"):
        workers.run(workers.raise_on, 2, 1, timeout=60)


def test_concurrent_run_local_calls_meet_in_their_own_groups():
    """Each call serves its own store on a port it already holds, so calls
    running at once neither fail to meet nor join each other's groups."""
    import threading

    got, errors = {}, []

    def call(tag):
        try:
            got[tag] = workers.run(workers.tagged_sum, 2, tag, timeout=120)
        except BaseException as e:      # re-raised below, in the test
            errors.append(e)

    threads = [threading.Thread(target=call, args=(tag,))
               for tag in (100, 200, 300)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert got == {tag: [2.0 * tag + 1] * 2 for tag in (100, 200, 300)}


def test_run_local_kills_children_at_the_timeout():
    before = set(p.pid for p in __import__("multiprocessing")
                 .active_children())
    with pytest.raises(TimeoutError, match="killed"):
        workers.run(workers.hang, 2, timeout=5)
    left = [p for p in __import__("multiprocessing").active_children()
            if p.pid not in before]
    assert not left


def test_allgather_and_merge_boxes(four):
    for merged in (r["boxes"] for r in four):
        assert sorted(merged) == [1, 2]
        assert sorted(merged[1]) == list(range(N))
        assert sorted(merged[2]) == [10 + r for r in range(N)]
        assert merged[1][1][0, 0] == 1.0
    parts = [{1: {0: np.ones((1, 5))}}, {1: {1: np.zeros((1, 5))}, 3: {}}]
    a, b = multihost.merge_all_boxes(parts), jax_merge(parts)
    assert a.keys() == b.keys() and all(a[k].keys() == b[k].keys()
                                        for k in a)
    assert multihost.allgather_object("x") == ["x"]
    np.testing.assert_array_equal(multihost.host_local_rows(
        torch.arange(3)), np.arange(3))


def test_maybe_init_distributed():
    assert multihost.maybe_init_distributed(print, "cpu") is None
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT="0")   # world 1: binds its own
    code = ("import torch.distributed as dist; "
            "from ait_tpu_torch.parallel.multihost import "
            "maybe_init_distributed as m; "
            "dev = m(print, 'cpu'); "
            "assert str(dev) == 'cpu' and dist.get_backend() == 'gloo'; "
            "assert dist.get_world_size() == 1; "
            "assert m(print, 'cpu') is None; dist.destroy_process_group()")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)


def test_mesh_layout_shard_batch_replicate(four):
    rows = np.arange(8 * 3).reshape(8, 3)
    for rank, (data, model, block, w) in enumerate(r["mesh"] for r in four):
        assert (data, model) == (rank // 2, rank % 2)
        np.testing.assert_array_equal(block, rows[4 * data:4 * data + 4])
        np.testing.assert_array_equal(w, np.zeros(4))


def test_fused_pmean_matches_jax(four):
    n, leaves = N, LEAVES
    mesh = make_mesh(n, axes=("data",))
    stacked = [np.concatenate([leaves[r][i] for r in range(n)])
               for i in range(3)]
    jax_out = jax.jit(shard_map(
        lambda *xs: jax_fused_pmean(list(xs), "data"), mesh,
        in_specs=(P("data"),) * 3, out_specs=P("data")))(*stacked)
    for rank, (got, calls) in enumerate(r["pmean"] for r in four):
        assert calls == ["torch.float32"]          # one all_reduce a dtype
        for i, g in enumerate(got):
            rows = leaves[rank][i].shape[0]
            want = np.asarray(jax_out[i])[rank * rows:(rank + 1) * rows]
            assert g.dtype == want.dtype
            np.testing.assert_allclose(g, want, rtol=1e-6, atol=1e-6)


def test_world_sizes_refused_with_the_sizes_that_fit():
    cfg = workers.tiny_cfg(tp_size=2)
    with pytest.raises(SystemExit, match=r"world sizes that split it: "
                       r"\[2, 4, 8\]"):
        trainval_net.parallel_layout(cfg, "tp_size", 6, 4)
    assert trainval_net.parallel_layout(cfg, "tp_size", 4, 4, 2) == 2
    with pytest.raises(SystemExit, match="needs a world size divisible"):
        trainval_net.parallel_layout(workers.tiny_cfg(sp_size=4), "sp_size",
                                     2, 8)


TINY = ["--set", "tpu.image_size", "(128, 160)", "tpu.portrait_bucket",
        "False", "tpu.compute_dtype", "float32",
        "TRAIN.SCALES", "(100,)", "TEST.SCALES", "(100,)",
        "TRAIN.RPN_PRE_NMS_TOP_N", "256", "TRAIN.RPN_POST_NMS_TOP_N", "32",
        "TRAIN.RPN_BATCHSIZE", "32", "TRAIN.BATCH_SIZE", "16",
        "TEST.RPN_PRE_NMS_TOP_N", "256", "TEST.RPN_POST_NMS_TOP_N", "32",
        "MAX_NUM_GT_BOXES", "8"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_parallel")
    for split in ("trainval", "test"):
        make_voc_devkit(str(root / "VOCdevkit2007"), image_set=split)
    return root


def _common(root):
    return ["--dataset", "pascal_voc", "--net", "res50", "--data_dir",
            str(root), "--nw", "0", "--save_dir", str(root / "models"),
            "--device", "cpu"]


def test_train_cli_on_two_ranks(root):
    argv = _common(root) + ["--seen", "1", "--bs", "4", "--epochs", "1",
                            "--disp_interval", "1",
                            "--checkpoint_interval", "100"] + TINY
    outs = workers.run(workers.cli, 2, "train", argv)
    assert [o["step"] for o in outs] == [2, 2]
    run_dir = outs[0]["run_dir"]
    ckpt = os.path.join(run_dir, "ckpt")
    assert sorted(os.listdir(ckpt)) == ["2"]
    assert sorted(os.listdir(os.path.join(ckpt, "2"))) == [
        "metadata.json", "state.pt"]
    assert os.path.isfile(os.path.join(run_dir, "config.json"))
    with open(os.path.join(run_dir, "logs", "metrics.jsonl")) as f:
        rows = f.readlines()
    assert len(rows) == 2 * 2          # a loss and a perf row a step, rank 0


def test_eval_cli_on_two_ranks_merges_every_pair(root):
    argv = _common(root) + ["--a", "1", "--version", "eval2"] + TINY
    outs = workers.run(workers.cli, 2, "eval",
                       argv + ["--bs", "2", "--output_dir",
                               str(root / "out2")])
    assert outs[0] == outs[1]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = test_net.main(argv + ["--bs", "1", "--output_dir",
                                       str(root / "out1")])
    finally:
        torch.set_num_threads(n)
    (name,) = [f for f in os.listdir(root / "out2") if f.endswith(".pkl")]
    a = read_data_pickle(str(root / "out2" / name))
    b = read_data_pickle(str(root / "out1" / name))
    assert sorted(a) == sorted(b)
    for ci in a:
        assert sorted(a[ci]) == sorted(b[ci])
        for ri in a[ci]:
            assert a[ci][ri].shape == b[ci][ri].shape
            np.testing.assert_allclose(a[ci][ri], b[ci][ri], rtol=1e-3,
                                       atol=1e-3)
    assert abs(outs[0][0]["mAP"] - single[0]["mAP"]) < 1e-6
