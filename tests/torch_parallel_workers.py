"""Rank workers of the parallel tests (tests/test_torch_parallel_*.py).

`ait_tpu_torch.parallel.launch.run_local` runs each in spawned processes,
which import this module afresh to find it: it imports no JAX and nothing
of the JAX package, so neither does any rank.  A worker takes (rank,
world_size, device, *args) and returns plain Python or numpy values.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ait_tpu_torch.config import Config
from ait_tpu_torch.models import AITDetector
from ait_tpu_torch.parallel import launch
from ait_tpu_torch.parallel.mesh import (axis_index, make_mesh, replicate,
                                         shard_batch)
from ait_tpu_torch.parallel.multihost import (allgather_object,
                                              merge_all_boxes)
from ait_tpu_torch.parallel.sharded import (fused_pmean,
                                            make_sharded_eval_step,
                                            make_sharded_train_step,
                                            shard_generator)
from ait_tpu_torch.train import (grads_and_metrics, init_weights,
                                 lr_schedule, make_eval_step, make_optimizer,
                                 make_train_step)
from ait_tpu_torch.utils.profiling import recording

H, W = 96, 128                    # the tiny canvas of the port's tests


def run(fn, world, *args, timeout=240.0):
    """run_local on the CPU under gloo with the tests' timeout."""
    return launch.run_local(fn, world, backend="gloo", device="cpu",
                            timeout=timeout, args=args)


def to_np(t):
    return t.detach().cpu().numpy()


# ---- the tiny flagship -----------------------------------------------------

def tiny_cfg(t_dropout=0.0, coattention="mha", **tpu) -> Config:
    """The tiny flagship's config (full ResNet-50 widths, TRAIN tops 64 ->
    16, 8 rois an image, TEST tops 32 -> 8), float32."""
    cfg = Config()
    return cfg.replace(
        TRAIN=dataclasses.replace(cfg.TRAIN, RPN_PRE_NMS_TOP_N=64,
                                  RPN_POST_NMS_TOP_N=16, RPN_BATCHSIZE=16,
                                  BATCH_SIZE=8),
        TEST=dataclasses.replace(cfg.TEST, RPN_PRE_NMS_TOP_N=32,
                                 RPN_POST_NMS_TOP_N=8),
        MAX_NUM_GT_BOXES=4,
        model=dataclasses.replace(cfg.model, t_dropout=t_dropout,
                                  coattention=coattention),
        tpu=dataclasses.replace(cfg.tpu, **tpu))


def tiny_batch(b=2, seed=0):
    rng = np.random.RandomState(seed)
    gt = np.zeros((b, 4, 5), np.float32)
    gt[:, 0] = [8, 8, 60, 60, 1]
    gt[1:, 1] = [30, 20, 100, 80, 1]
    return {"image": torch.from_numpy(
                rng.randint(0, 256, (b, H, W, 3)).astype(np.uint8)),
            "query": torch.from_numpy(
                rng.randint(0, 256, (b, 128, 128, 3)).astype(np.uint8)),
            "im_info": torch.from_numpy(np.tile(
                np.asarray([[H - 8, W - 16, 1.0]], np.float32), (b, 1))),
            "gt_boxes": torch.from_numpy(gt)}


def tiny_model(cfg, mesh=None, seed=0):
    return init_weights(AITDetector(cfg, mesh=mesh), seed)


def trainer(model, cfg, mesh=None, **kw):
    opt = make_optimizer(cfg, model)
    sched = lr_schedule(0.01, 100, 4, 0.1)
    if mesh is None:
        return make_train_step(model, opt, sched, device="cpu", **kw)
    return make_sharded_train_step(model, opt, sched, mesh, device="cpu",
                                   **kw)


def digest(model) -> str:
    h = hashlib.sha256()
    for name, t in model.state_dict().items():
        h.update(name.encode())
        h.update(to_np(t).tobytes())
    return h.hexdigest()


def leaf_errors(got: dict, want: dict, floor=0.0, rtol=0.0) -> dict:
    """{name: max(|got - want| - rtol |want|) / max(max |want|, floor)} over
    want's keys: at most atol holds numpy's allclose(got, want, rtol,
    atol x that scale)."""
    out = {}
    for k, w in want.items():
        w = w.double()
        scale = max(float(w.abs().max()), floor)
        out[k] = float(((got[k].double() - w).abs() - rtol * w.abs()).max()
                       ) / (scale or 1.0)
    return out


# ---- launch / multihost / mesh ---------------------------------------------

def glue(rank, world, dev, leaves):
    """One world of 4 for the multi-process glue: this rank's view of the
    run, the merged boxes, its mesh layout and its fused_pmean."""
    return {"rank_world": (rank, world, str(dev), torch.get_num_threads()),
            "boxes": gather_boxes(rank, world, dev),
            "mesh": mesh_layout(rank, world, dev),
            "pmean": pmean(rank, world, dev, leaves)}


def raise_on(rank, world, dev, bad):
    if rank == bad:
        raise ValueError(f"boom on rank {rank}")
    dist.barrier()


def hang(rank, world, dev):
    """Rank 1 never enters the collective that rank 0 waits in."""
    if rank == 1:
        time.sleep(3600)
    dist.barrier()


def loaded_modules(rank, world, dev):
    return sorted(sys.modules), os.getpid()


def tagged_sum(rank, world, dev, tag):
    """The sum over the group of tag + rank: a rank that joined another
    call's group would add another tag."""
    t = torch.tensor([float(tag + rank)])
    dist.all_reduce(t)
    return float(t)


def gather_boxes(rank, world, dev):
    part = {1: {rank: np.full((1, 5), rank, np.float32)},
            2: {10 + rank: np.zeros((0, 5), np.float32)}}
    return merge_all_boxes(allgather_object(part))


def mesh_layout(rank, world, dev):
    """Coordinates on a (data x model) mesh, this rank's block of a batch,
    and a replicated tensor."""
    mesh = make_mesh(world, axes=("data", "model"), shape=(world // 2, 2))
    batch = {"x": torch.arange(8 * 3).reshape(8, 3)}
    block = shard_batch(batch, mesh)["x"]
    state = {"w": torch.full((4,), float(rank))}
    replicate(state, mesh)
    return (axis_index(mesh, "data"), axis_index(mesh, "model"),
            to_np(block), to_np(state["w"]))


def pmean(rank, world, dev, leaves):
    """fused_pmean of this rank's leaves, and the all_reduce calls it made."""
    calls = []
    all_reduce = dist.all_reduce

    def counted(*a, **kw):
        calls.append(a[0].dtype)
        return all_reduce(*a, **kw)

    dist.all_reduce = counted
    try:
        mine = [torch.from_numpy(a.copy()) for a in leaves[rank]]
        fused_pmean(mine, dist.group.WORLD)
    finally:
        dist.all_reduce = all_reduce
    return [to_np(t) for t in mine], [str(c) for c in calls]


# ---- data parallelism ------------------------------------------------------

def dp_world1(rank, world, dev):
    """Two steps of make_sharded_train_step on a one-rank 'data' mesh and of
    make_train_step, from the same weights and generator state, t_dropout
    0.1: (losses equal, params equal after each step), and the sharded eval
    step against make_eval_step."""
    cfg = tiny_cfg(t_dropout=0.1)
    mesh = make_mesh(1)
    a, b = tiny_model(cfg), tiny_model(cfg)
    sa, sb = trainer(a, cfg, mesh), trainer(b, cfg)
    ga = torch.Generator().manual_seed(7)
    gb = torch.Generator().manual_seed(7)
    same = []
    for i in range(2):
        batch = tiny_batch(1, seed=i)
        ma, mb = sa(batch, ga), sb(batch, gb)
        same.append((all(torch.equal(ma[k], mb[k]) for k in mb),
                     all(torch.equal(x, y) for x, y in
                         zip(a.state_dict().values(),
                             b.state_dict().values()))))
    a.eval()
    b.eval()
    batch = tiny_batch(1, seed=5)
    ea = make_sharded_eval_step(a, mesh)(batch)
    eb = make_eval_step(b)(batch)
    same.append((all(torch.equal(ea[k], eb[k]) for k in eb), True))
    return same


def dp2(rank, world, dev):
    """One dp2 sharded train step (t_dropout 0.1, 1 image a rank), recorded:
    the params' digest of every rank, this rank's recorded spans and
    counts against the bytes it reduces, and on rank 0 the reduced
    gradients and metrics against the mean of grads_and_metrics on each
    half under that half's derived generator, computed here."""
    cfg = tiny_cfg(t_dropout=0.1)
    mesh = make_mesh(world)
    model = tiny_model(cfg, mesh)
    step = trainer(model, cfg, mesh)
    batch = tiny_batch(2, seed=3)
    gen = torch.Generator().manual_seed(11)
    start = gen.get_state()
    with recording() as rec:
        metrics = step(shard_batch(batch, mesh), gen)
    reduced = sum(p.grad.numel() * p.grad.element_size()
                  for p in model.parameters() if p.grad is not None)
    reduced += sum(v.numel() * v.element_size() for v in metrics.values())
    recorded = ([(s.name, dict(s.counts)) for s in rec.spans], reduced)
    digests = allgather_object(digest(model))
    if rank:
        return digests, None, recorded
    got = {k: p.grad.clone() for k, p in model.named_parameters()
           if p.grad is not None}
    ref = tiny_model(cfg).train()
    halves = []
    for i in range(world):
        ref.zero_grad(set_to_none=True)
        g = torch.Generator()
        g.set_state(start)
        m = grads_and_metrics(ref, {k: v[i:i + 1] for k, v in batch.items()},
                              shard_generator(g, i))
        halves.append(({k: p.grad.clone() for k, p in ref.named_parameters()
                        if p.grad is not None}, m))
    want = {k: sum(h[0][k] for h in halves) / world for k in got}
    errs = leaf_errors(got, want)
    counts = {k: (float(metrics[k]), float(sum(h[1][k] for h in halves)))
              for k in ("fg_cnt", "bg_cnt")}
    losses = {k: (float(metrics[k]),
                  float(sum(h[1][k] for h in halves)) / world)
              for k in metrics if k not in counts}
    return digests, (errs, counts, losses, sorted(got) == sorted(want)), \
        recorded


def dp2_eval(rank, world, dev):
    """The sharded eval step on a 'data' mesh of 2 (1 image a rank) and,
    on rank 0, make_eval_step on each image alone."""
    cfg = tiny_cfg()
    mesh = make_mesh(world)
    model = tiny_model(cfg, mesh).eval()
    batch = tiny_batch(2, seed=4)
    out = make_sharded_eval_step(model, mesh)(shard_batch(batch, mesh))
    parts = allgather_object({k: to_np(v) for k, v in out.items()})
    if rank:
        return None
    step = make_eval_step(model)
    alone = [{k: to_np(v) for k, v in step(
        {k: v[i:i + 1] for k, v in batch.items()}).items()}
        for i in range(world)]
    return parts, alone


# ---- tensor parallelism ----------------------------------------------------

def tp_transformer(rank, world, dev, state, props, query):
    """The tiny transformer over a 'model' mesh of `world`: its output and,
    after tp_psum_grads, every parameter's gradient of sum(out^2)."""
    from ait_tpu_torch.models.ait_transformer import AITTransformer
    from ait_tpu_torch.parallel.tp import tp_psum_grads

    mesh = make_mesh(world, axes=("model",))
    model = AITTransformer(d_model=32, d_inner=64, n_layers=1, n_head=4,
                           d_k=8, d_v=8, n_position=16, channels=64,
                           tp_size=world,
                           tp_group=mesh.get_group("model"))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    out = model(torch.from_numpy(props), torch.from_numpy(query))
    (out.float() ** 2).sum().backward()
    tp_psum_grads(model, mesh.get_group("model"))
    return to_np(out), {k: to_np(p.grad) for k, p in model.named_parameters()}


def tp_detector(rank, world, dev, t_dropouts):
    """{t_dropout: tp_step(t_dropout)} for each rate."""
    return {t: tp_step(rank, world, t) for t in t_dropouts}


def tp_step(rank, world, t_dropout):
    """One train step on a (data 1 x model 2) mesh and, on rank 0, the
    world-1 make_train_step on the same weights, batch and generator:
    ({metric: (tp, plain)}, {param: its error past 1e-4 relative, over
    max(1e-3, max |plain|)}, params bitwise equal across the ranks)."""
    cfg = tiny_cfg(t_dropout=t_dropout, tp_size=world)
    mesh = make_mesh(world, axes=("data", "model"), shape=(1, world))
    model = tiny_model(cfg, mesh)
    batch = tiny_batch(2, seed=6)
    m = trainer(model, cfg, mesh, tp_axis="model")(
        batch, torch.Generator().manual_seed(13))
    digests = allgather_object(digest(model))
    if rank:
        return None
    ref = tiny_model(tiny_cfg(t_dropout=t_dropout))
    mr = trainer(ref, tiny_cfg(t_dropout=t_dropout))(
        batch, torch.Generator().manual_seed(13))
    metrics = {k: (float(m[k]), float(mr[k])) for k in mr}
    want = dict(ref.named_parameters())
    errs = leaf_errors(dict(model.named_parameters()), want, floor=1e-3,
                       rtol=1e-4)
    return metrics, errs, len(set(digests)) == 1


# ---- sequence parallelism --------------------------------------------------

def sp_attention(rank, world, dev, q, k, v, mask, scale):
    """seq_parallel_attention over a 'seq' mesh: the output, dq, and this
    rank's blocks of dk and dv, for the loss sum(out^2)."""
    from ait_tpu_torch.parallel.sp import seq_parallel_attention, shard_seq

    mesh = make_mesh(world, axes=("seq",))
    qt = torch.from_numpy(q).requires_grad_()
    kt = shard_seq(torch.from_numpy(k), mesh).detach().requires_grad_()
    vt = shard_seq(torch.from_numpy(v), mesh).detach().requires_grad_()
    mt = None if mask is None else shard_seq(torch.from_numpy(mask), mesh,
                                             dim=-1)
    out = seq_parallel_attention(qt, kt, vt, mesh.get_group("seq"), scale,
                                 mt)
    (out ** 2).sum().backward()
    return to_np(out), to_np(qt.grad), to_np(kt.grad), to_np(vt.grad)


def sp_coattention(rank, world, dev, cases, x_img, x_qry):
    """{(kind, norm): outputs} of co-attention modules with their image
    tokens over a 'seq' mesh; cases: {(kind, norm): state_dict}."""
    from ait_tpu_torch.models.coattention import (MHACoAttention,
                                                  NonLocalCoAttention)

    mesh = make_mesh(world, axes=("seq",))
    group = mesh.get_group("seq")
    c = x_img.shape[-1]
    out = {}
    for (kind, norm), state in cases.items():
        if kind == "mha":
            mod = MHACoAttention(c, n_head=4, d_k=8, d_v=8, sp_group=group)
        else:
            mod = NonLocalCoAttention(c, norm, sp_group=group)
        mod.load_state_dict({k: torch.from_numpy(v)
                             for k, v in state.items()})
        with torch.inference_mode():
            a, b = mod(torch.from_numpy(x_img), torch.from_numpy(x_qry))
        out[kind, norm] = to_np(a), to_np(b)
    return out


def sp_detector(rank, world, dev, coattention):
    """Eval on a (data 1 x seq 2) mesh and, on rank 0, unsharded eval of the
    same weights: both outputs."""
    cfg = tiny_cfg(coattention=coattention, sp_size=world)
    mesh = make_mesh(world, axes=("data", "seq"), shape=(1, world))
    model = tiny_model(cfg, mesh).eval()
    batch = tiny_batch(2, seed=8)
    got = make_sharded_eval_step(model, mesh)(batch)
    train_error = None
    try:
        model.train()(batch["image"], batch["query"], batch["im_info"],
                      batch["gt_boxes"], train=True,
                      generator=torch.Generator())
    except ValueError as e:
        train_error = str(e)
    if rank:
        return None
    ref = tiny_model(tiny_cfg(coattention=coattention)).eval()
    want = make_eval_step(ref)(batch)
    return ({k: to_np(v) for k, v in got.items()},
            {k: to_np(v) for k, v in want.items()}, train_error)


# ---- pipeline --------------------------------------------------------------

def pp_stage(p, x):
    """tests/test_pp.py's residual MLP stage."""
    return x + torch.tanh(x @ p["w1"] + p["b1"]) @ p["w2"]


def pipeline(rank, world, dev, stacked, x, m):
    """make_pipeline_apply over a 'stage' mesh: the M outputs (the ranks'
    blocks gathered) and this rank's stage gradients of sum(y^2) summed
    over the ranks' blocks."""
    from ait_tpu_torch.parallel.pp import (make_pipeline_apply,
                                           shard_stage_params)

    mesh = make_mesh(world, axes=("stage",))
    mine = shard_stage_params(
        {k: torch.from_numpy(v) for k, v in stacked.items()}, mesh)
    mine = {k: v.requires_grad_() for k, v in mine.items()}
    y = make_pipeline_apply(pp_stage, mesh, m)(mine, torch.from_numpy(x))
    (y ** 2).sum().backward()
    blocks = allgather_object(to_np(y))
    grads = allgather_object({k: to_np(v.grad) for k, v in mine.items()})
    return np.concatenate(blocks), grads


def encoder_pipeline(rank, world, dev, states, x, m):
    """Stages that are the AIT encoder layer (the port's EncoderLayer, plain
    path on the CPU): outputs and this rank's stage gradients."""
    from ait_tpu_torch.models.ait_transformer import EncoderLayer
    from ait_tpu_torch.parallel.pp import make_pipeline_apply

    mesh = make_mesh(world, axes=("stage",))
    layer = EncoderLayer(32, 64, 4, 8, 8)
    layer.load_state_dict({k: torch.from_numpy(v)
                           for k, v in states[rank].items()})
    y = make_pipeline_apply(lambda mod, a: mod(a, None), mesh, m)(
        layer, torch.from_numpy(x))
    (y ** 2).sum().backward()
    return (np.concatenate(allgather_object(to_np(y))),
            {k: to_np(p.grad) for k, p in layer.named_parameters()})


# ---- the CLIs --------------------------------------------------------------

def cli(rank, world, dev, which, argv):
    """trainval_net.main or test_net.main on every rank (TensorBoard's
    import blocked: the metrics go to the JSONL alone)."""
    sys.modules["torch.utils.tensorboard"] = None
    from ait_tpu_torch.tools import test_net, trainval_net

    mod = trainval_net if which == "train" else test_net
    return mod.main(argv)

