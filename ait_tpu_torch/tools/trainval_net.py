"""One-shot detection training CLI (counterpart of tools/trainval_net.py).

    python -m ait_tpu_torch.tools.trainval_net --dataset pascal_voc \\
        --net res50 --bs 8 --epochs 10 [--r true] [--set KEY VALUE ...]

The same flags and defaults as the JAX package's CLI, plus `--device`
(the GPU unless named, e.g. `--device cpu`).  `build_config` gives the
same `Config` as the JAX CLI's for the same flags: the recipe
`cfgs/{net}[_{g}][_ls].yml`, the dataset's anchor scales and box cap, the
backbone, the co-attention flavour and `class_agnostic`, then `--set`.

One process a device.  Alone, the run is `OneShotLoader(training=True)` ->
`device_prefetch` -> `make_train_step`.  Under torchrun,

    torchrun --nproc_per_node N -m ait_tpu_torch.tools.trainval_net ... \
        [--set tpu.tp_size T]

every rank joins the process group (`parallel.maybe_init_distributed`:
NCCL on its card, gloo with `--device cpu`), the ranks form a (data x model)
mesh of (N / T) x T, the loader feeds each data rank its slice of every
batch (`process_index` = data rank, `process_count` = data size), and
`parallel.make_sharded_train_step` takes the step: one mean of the
gradients over the data ranks, the heads and FFN units split over the model
ranks.  Only rank 0 writes config.json, the metrics and the checkpoints
(all ranks wait for each save, then all restore).  A world size that the
batch, `--grad_accum` and tp cannot split is refused up front with the
sizes that would work: a torchrun rank cannot sit idle in a collective,
where the JAX CLI leaves devices idle (tools/trainval_net.py:232-254).

The step's generator is seeded from (RNG_SEED + session, step), the port's
counterpart of
`fold_in(rng, state.step)`, so a resumed run draws what the first run
would have drawn at that step.  The run directory is
`<save_dir>/<net>/<dataset>/<version>/`: `config.json` (`save_config`),
`logs/metrics.jsonl` (and TensorBoard events where importable) and
`ckpt/<step>/` (train/checkpoint.py), saved every `--checkpoint_interval`
steps and at each epoch's end; `--r true` restores the newest and resumes
at epoch latest // steps_per_epoch + 1, as the JAX CLI does.

Every recipe trains: `--dataset coco` (the non-local co-attention, anchor
scales (4, 8, 16, 32), 50 boxes a image) and `--net vgg16` (its global-norm
clip at 10).  `tpu.sp_size` > 1 is refused: sequence parallelism is an
inference-path feature (the eval CLI runs it).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ait_tpu_torch.config import Config
from ait_tpu_torch.convert import load_pretrained
from ait_tpu_torch.data import OneShotLoader, device_prefetch
from ait_tpu_torch.data import coco as coco_data
from ait_tpu_torch.data import voc as voc_data
from ait_tpu_torch.device import resolve_device
from ait_tpu_torch.models import AITDetector
from ait_tpu_torch.models.detector import check_tp_size
from ait_tpu_torch.parallel import multihost
from ait_tpu_torch.parallel.mesh import axis_index, make_mesh, replicate
from ait_tpu_torch.parallel.sharded import make_sharded_train_step
from ait_tpu_torch.train import (init_params, lr_schedule, make_optimizer,
                                 make_train_step)
from ait_tpu_torch.train.checkpoint import CheckpointManager, save_config
from ait_tpu_torch.utils import (AverageMeter, MetricWriter, ThroughputMeter,
                                 printer)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
LOSS_KEYS = ("loss", "rpn_cls", "rpn_box", "rcnn_cls", "margin", "rcnn_box")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train the one-shot detector")
    p.add_argument("--dataset", default="pascal_voc_0712",
                   choices=["pascal_voc", "pascal_voc_0712", "coco"])
    p.add_argument("--net", default="res50",
                   choices=["res50", "res101", "vgg16"])
    p.add_argument("--start_epoch", type=int, default=1)
    p.add_argument("--epochs", dest="max_epochs", type=int, default=10)
    p.add_argument("--disp_interval", type=int, default=20)
    p.add_argument("--checkpoint_interval", type=int, default=10000)
    p.add_argument("--save_dir", default="models")
    p.add_argument("--data_dir", default="data")
    p.add_argument("--coco_set", default="2017_train",
                   help="coco <year>_<split>, e.g. 2017_train, 2014_minival")
    p.add_argument("--nw", dest="num_workers", type=int, default=8)
    p.add_argument("--g", dest="group", type=int, default=0)
    p.add_argument("--seen", type=int, default=1)
    p.add_argument("--bs", dest="batch_size", type=int, default=8)
    p.add_argument("--grad_accum", type=int, default=1,
                   help="run the batch as N sequential microbatches per "
                        "optimizer step")
    p.add_argument("--cag", dest="class_agnostic", default=True)
    p.add_argument("--o", dest="optimizer", default="sgd",
                   choices=["sgd", "adam"])
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--lr_decay_step", type=int, default=4)
    p.add_argument("--lr_decay_gamma", type=float, default=0.1)
    p.add_argument("--warmup_steps", type=int, default=0)
    p.add_argument("--session", type=int, default=1)
    p.add_argument("--r", dest="resume", default=False,
                   type=lambda s: str(s).lower() in ("1", "true", "yes"))
    p.add_argument("--version", default="1.0.0")
    p.add_argument("--ls", dest="large_scale", action="store_true")
    p.add_argument("--pretrained", default=None,
                   help="path to a converted backbone/model params pickle "
                        "(nested dict of arrays, the output of "
                        "tools/convert_torch_checkpoint.py)")
    p.add_argument("--debug", action="store_true",
                   help="truncate to 5 iters/epoch")
    p.add_argument("--set", dest="set_cfgs", nargs="*", default=[],
                   help="dotted-key config overrides, e.g. "
                        "TRAIN.RPN_PRE_NMS_TOP_N 6000")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' to run on "
                        "the CPU)")
    return p.parse_args(argv)


def build_config(args) -> Config:
    """The JAX CLI's build_config (tools/trainval_net.py:92-121)."""
    suffix = "_ls" if args.large_scale else ""
    name = (f"{args.net}_{args.group}{suffix}" if args.group != 0
            else f"{args.net}{suffix}")
    cfg_file = os.path.join(REPO, "cfgs", f"{name}.yml")
    cfg = Config.from_yaml(cfg_file) if os.path.exists(cfg_file) else Config()
    printer("Config: ", cfg_file)

    # dataset-level overrides (trainval_net_voc.py:193-204)
    if args.dataset == "coco":
        cfg = cfg.override(["ANCHOR_SCALES", "(4, 8, 16, 32)",
                            "MAX_NUM_GT_BOXES", "50"])
        coatt = "nonlocal"
    else:
        cfg = cfg.override(["ANCHOR_SCALES", "(8, 16, 32)",
                            "MAX_NUM_GT_BOXES", "20"])
        coatt = "mha"
    backbone = {"res50": "resnet50", "res101": "resnet101",
                "vgg16": "vgg16"}[args.net]
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, backbone=backbone, coattention=coatt,
        channels=512 if backbone == "vgg16" else 1024,
        class_agnostic=bool(args.class_agnostic)))
    if args.set_cfgs:
        cfg = cfg.override(args.set_cfgs)
    return cfg


def parallel_layout(cfg: Config, knob: str, world: int, batch_size: int,
                    accum: int = 1) -> int:
    """The data size of a world of `world` ranks with tpu.<knob> (tp_size or
    sp_size) ranks to a data rank; refuses (SystemExit), before any data or
    model work, a size the heads, the world or the batch cannot take."""
    size = int(getattr(cfg.tpu, knob))
    if knob == "tp_size":
        try:
            check_tp_size(cfg)
        except ValueError as e:
            raise SystemExit(str(e)) from None
    if world % size:
        raise SystemExit(f"tpu.{knob} {size}: needs a world size divisible "
                         f"by it, have {world}")
    dp = world // size
    if batch_size % (dp * accum):
        fits = [d * size for d in range(1, batch_size + 1)
                if batch_size % (d * accum) == 0]
        raise SystemExit(
            f"world size {world}: batch {batch_size} does not split into "
            f"{dp} data ranks x {accum} microbatches (tpu.{knob} {size}); "
            f"world sizes that split it: {fits}")
    return dp


def make_run_mesh(axis: str, dp: int, size: int):
    """The (data x axis) mesh of an initialized world, 'data' alone at
    size 1; None without a process group."""
    if not dist.is_initialized():
        return None
    if size > 1:
        mesh = make_mesh(dp * size, axes=("data", axis), shape=(dp, size))
    else:
        mesh = make_mesh(dp)
    printer(f"Mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    return mesh


def build_view(args, cfg):
    cache = os.path.join(args.data_dir, "cache")
    if args.dataset == "coco":
        year, split = args.coco_set.split("_", 1)
        view = coco_data.load_coco(os.path.join(args.data_dir, "coco"),
                                   year, split, cache_dir=cache)
        return coco_data.filter_seen(view, args.seen,
                                     cfg.train_categories[0])
    sets = ([("2007", "trainval")] if args.dataset == "pascal_voc"
            else [("2007", "trainval"), ("2012", "trainval")])
    views = []
    for year, split in sets:
        devkit = os.path.join(args.data_dir, f"VOCdevkit{year}")
        v = voc_data.load_voc(devkit, year, split, cache_dir=cache)
        views.append(voc_data.filter_seen(v, args.seen))
    view = views[0]
    for other in views[1:]:  # multi-dataset merge (roidb.py:178-184)
        view.records.extend(other.records)
        for c, pool in other.cat_data.items():
            view.cat_data[c].extend(pool)
    return view


def compute_dtype(cfg: Config) -> torch.dtype:
    """cfg.tpu.compute_dtype ('bfloat16' or 'float32') as a torch dtype;
    parameters stay float32 either way."""
    return getattr(torch, cfg.tpu.compute_dtype)


def run_dir(args) -> str:
    return os.path.join(args.save_dir, args.net, args.dataset, args.version)


def step_generator(cfg: Config, session: int, step: int,
                   device) -> torch.Generator:
    """The generator of train step `step`: seeded from (RNG_SEED + session,
    step), so a resumed run draws what an uninterrupted one would."""
    seed = ((cfg.RNG_SEED + session) << 32) + step
    return torch.Generator(device=device).manual_seed(seed)


def main(argv=None, *,
         imread: Optional[Callable[[str], np.ndarray]] = None) -> dict:
    """Train; `imread` reads an image path to an RGB array (the loader's
    default decodes with imageio).  Returns the run's directory, its steps
    an epoch, its first epoch and step, and its last step."""
    args = parse_args(argv)
    cfg = build_config(args)
    if int(cfg.tpu.sp_size) > 1:
        raise SystemExit("tpu.sp_size > 1: sequence parallelism is an "
                         "inference-path feature (the eval CLI runs it)")
    if args.batch_size % args.grad_accum != 0:
        raise SystemExit(
            f"--grad_accum {args.grad_accum}: batch {args.batch_size} "
            "must be divisible by the microbatch count")
    dev = multihost.maybe_init_distributed(printer, args.device) or \
        resolve_device(args.device)
    rank, world = multihost.world()
    tp = int(cfg.tpu.tp_size)
    dp = parallel_layout(cfg, "tp_size", world, args.batch_size,
                         args.grad_accum)
    np.random.seed(cfg.RNG_SEED)
    mesh = make_run_mesh(cfg.tpu.tp_axis, dp, tp)
    data_rank = 0 if mesh is None else axis_index(mesh, "data")

    view = build_view(args, cfg)
    printer(f"{len(view.records)} roidb entries (pre-augment)")
    loader = OneShotLoader(view, cfg, training=True, imread=imread,
                           process_index=data_rank, process_count=dp)
    printer(f"{len(loader)} training records after flip+filter")

    output_dir = run_dir(args)
    os.makedirs(output_dir, exist_ok=True)
    # one config and one metrics stream a run: rank 0 writes them
    writer = None
    if rank == 0:
        save_config(output_dir, cfg)
        writer = MetricWriter(os.path.join(output_dir, "logs"))

    model = init_params(AITDetector(cfg, dtype=compute_dtype(cfg),
                                    mesh=mesh), cfg, cfg.RNG_SEED)
    if args.pretrained:
        n = load_pretrained(model, args.pretrained)
        printer(f"Loaded {n} pretrained arrays from ", args.pretrained)
    model.to(dev)

    steps_per_epoch = max(len(loader) // args.batch_size, 1)
    sched = lr_schedule(args.lr, steps_per_epoch, args.lr_decay_step,
                        args.lr_decay_gamma,
                        warmup_steps=args.warmup_steps)
    opt = make_optimizer(cfg, model, optimizer=args.optimizer,
                         clip_norm=10.0 if args.net == "vgg16" else None)

    ckpt = CheckpointManager(os.path.join(output_dir, "ckpt"))

    def save(step, epoch, force=False):
        # rank 0 writes (a save removes the temporary directories it finds,
        # so concurrent writers would remove each other's); all ranks wait
        if rank == 0:
            ckpt.save(step, model, opt, metadata={
                "epoch": epoch, "session": args.session}, force=force)
        if mesh is not None:
            dist.barrier()

    start_epoch, start_step = args.start_epoch, 0
    if args.resume:
        restored = ckpt.restore(model, opt)
        if restored is not None:
            start_step = restored[0]
            start_epoch = start_step // steps_per_epoch + 1
            printer(f"Resumed from step {start_step} -> epoch {start_epoch}")
    if mesh is not None:
        replicate(model, mesh)

    accum = args.grad_accum
    if accum > 1:
        printer(f"Gradient accumulation: {accum} microbatches of "
                f"{args.batch_size // (dp * accum)} per step and data rank")
    if mesh is None:
        step_fn = make_train_step(model, opt, sched, device=dev,
                                  accum_steps=accum, start_step=start_step)
    else:
        step_fn = make_sharded_train_step(
            model, opt, sched, mesh, accum_steps=accum, device=dev,
            tp_axis=cfg.tpu.tp_axis if tp > 1 else None,
            start_step=start_step)

    meters = {k: AverageMeter() for k in LOSS_KEYS}
    thru = ThroughputMeter()
    try:
        for epoch in range(start_epoch, args.max_epochs + 1):
            for m in meters.values():
                m.reset()
            thru.reset()
            epoch_batches = loader.train_epoch(args.batch_size,
                                               num_workers=args.num_workers)
            try:
                for it, batch in enumerate(device_prefetch(epoch_batches,
                                                           device=dev)):
                    if args.debug and it >= 5:
                        break
                    metrics = step_fn(batch, step_generator(
                        cfg, args.session, step_fn.step, dev))
                    thru.tick(args.batch_size)
                    step = step_fn.step
                    if rank == 0 and ((it + 1) % args.disp_interval == 0
                                      or args.debug):
                        metrics = {k: float(v) for k, v in metrics.items()}
                        for k, m in meters.items():
                            m.update(metrics[k])
                        sps, pps = thru.rates()
                        printer(
                            f"[session {args.session}][epoch {epoch:2d}]"
                            f"[iter {it + 1:5d}/{steps_per_epoch}] ",
                            f"loss {meters['loss'].avg:.4f} "
                            f"(rpn {meters['rpn_cls'].avg:.3f}/"
                            f"{meters['rpn_box'].avg:.3f} "
                            f"rcnn {meters['rcnn_cls'].avg:.3f}/"
                            f"{meters['rcnn_box'].avg:.3f} "
                            f"margin {meters['margin'].avg:.3f}) "
                            f"fg/bg {int(metrics['fg_cnt'])}/"
                            f"{int(metrics['bg_cnt'])} "
                            f"| {sps:.2f} it/s, {pps:.1f} pairs/s")
                        writer.write(step, {k: m.avg
                                            for k, m in meters.items()})
                        writer.write(step, {"steps_per_sec": sps,
                                            "pairs_per_sec": pps},
                                     prefix="perf")
                    if step % args.checkpoint_interval == 0:
                        save(step, epoch)
            finally:
                epoch_batches.close()
            step = step_fn.step
            save(step, epoch, force=True)
            printer(f"Saved checkpoint at epoch {epoch}, step {step}")
    finally:
        ckpt.wait()
        if writer is not None:
            writer.close()
    printer("Training done.")
    return {"run_dir": output_dir, "steps_per_epoch": steps_per_epoch,
            "start_epoch": start_epoch, "start_step": start_step,
            "step": step_fn.step}


if __name__ == "__main__":
    main()
