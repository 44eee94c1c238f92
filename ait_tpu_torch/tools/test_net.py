"""One-shot detection evaluation CLI (counterpart of tools/test_net.py).

    python -m ait_tpu_torch.tools.test_net --dataset pascal_voc --net res50 \\
        --a 4 [--fuse_shots] [--checkpoint_path DIR | --pretrained PKL]

Iterates the (image x class) pair list `--a N` times with a different
deterministic query shot per pass (`loader.query_position`,
test_net_voc.py:320-322), caches the detections of each pass as a pickle
under `--output_dir`, and evaluates each pass (VOC AP per class) and their
average.  `--fuse_shots` computes all shots in one sweep, the image
backbone once per image (`make_fused_eval_step`): the same per-pair
program, whose detections differ from the per-pass ones only where the
convolutions round the image backbone at another batch otherwise.
The same flags as the JAX package's CLI, plus `--device` (the GPU unless
named).

The model's architecture knobs come from the run's `config.json` where it
exists (POOLING_MODE and the whole `model` block, as the JAX CLI adopts
them), its weights from `--checkpoint_path` (a `ckpt/` directory of the
port's train CLI), from `<save_dir>/<net>/<dataset>/<version>/ckpt`, or
from `--pretrained` (a converted params pickle,
`python -m ait_tpu_torch.tools.convert_torch_checkpoint`); without any, the
random weights from RNG_SEED, with a warning.  `--dataset coco` evaluates
with the COCO protocol (evaluation/coco_eval.py, AP50 as the headline).
Refused up front: `tpu.tp_size` or `tpu.sp_size` > 1 (A15), and `--vis`
(A13b: its drawing needs cv2).
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import pickle
import time
from typing import Callable, Optional

import numpy as np

from ait_tpu_torch.convert import load_pretrained
from ait_tpu_torch.data import OneShotLoader, device_prefetch
from ait_tpu_torch.data import coco as coco_data
from ait_tpu_torch.data import voc as voc_data
from ait_tpu_torch.data.coco import read_data_pickle
from ait_tpu_torch.device import resolve_device
from ait_tpu_torch.evaluation import (comp_id_tag, evaluate_voc,
                                      postprocess_detections,
                                      write_experiment_info,
                                      write_voc_results_files)
from ait_tpu_torch.evaluation.coco_eval import (COCODetEval,
                                                dets_to_coco_results)
from ait_tpu_torch.models import AITDetector
from ait_tpu_torch.tools.trainval_net import (build_config, check_scope,
                                              compute_dtype)
from ait_tpu_torch.train import (init_weights, make_eval_step,
                                 make_fused_eval_step)
from ait_tpu_torch.train.checkpoint import CheckpointManager
from ait_tpu_torch.utils import printer

INPUTS = ("image", "query", "im_info")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate the one-shot detector")
    p.add_argument("--dataset", default="pascal_voc_0712",
                   choices=["pascal_voc", "pascal_voc_0712", "coco"])
    p.add_argument("--net", default="res50",
                   choices=["res50", "res101", "vgg16"])
    p.add_argument("--save_dir", default="models")
    p.add_argument("--data_dir", default="data")
    p.add_argument("--coco_set", default="2017_val",
                   help="coco <year>_<split>, e.g. 2017_train, 2014_minival")
    p.add_argument("--nw", dest="num_workers", type=int, default=8)
    p.add_argument("--g", dest="group", type=int, default=0)
    p.add_argument("--seen", type=int, default=2)
    p.add_argument("--a", dest="average", type=int, default=1,
                   help="number of query shots to average over")
    p.add_argument("--bs", dest="batch_size", type=int, default=8,
                   help="eval batch size (the reference is fixed at 1)")
    p.add_argument("--session", dest="checksession", type=int, default=1)
    p.add_argument("--checkpoint_path", default=None,
                   help="explicit checkpoint dir (the run's ckpt/; else "
                        "derived from save_dir/net/dataset/version)")
    p.add_argument("--pretrained", default=None,
                   help="converted torch-checkpoint params pickle "
                        "(tools/convert_torch_checkpoint.py output) to "
                        "evaluate directly, bypassing the checkpoints")
    p.add_argument("--version", default="1.0.0")
    p.add_argument("--ls", dest="large_scale", action="store_true")
    p.add_argument("--cag", dest="class_agnostic", default=True)
    p.add_argument("--with_cache_file", action="store_true",
                   help="reuse cached detections instead of re-running")
    p.add_argument("--fuse_shots", action="store_true",
                   help="evaluate all --a query shots in one sweep, "
                        "computing the target-image backbone once per "
                        "image instead of once per shot (the per-pass "
                        "protocol's program)")
    p.add_argument("--output_dir", default="output")
    p.add_argument("--debug", action="store_true",
                   help="truncate to 10 pairs")
    p.add_argument("--vis", dest="visualization", action="store_true",
                   help="detection overlays (not ported yet: ROADMAP A13b)")
    p.add_argument("--write_results", action="store_true",
                   help="VOC only: also write official devkit result files "
                        "(pascal_voc.py:312-328) under "
                        "<data_dir>/VOCdevkit2007/results, tagged by the "
                        "experiment.info comp-id")
    p.add_argument("--set", dest="set_cfgs", nargs="*", default=[])
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' to run on "
                        "the CPU)")
    return p.parse_args(argv)


def build_view(args, cfg):
    cache = os.path.join(args.data_dir, "cache")
    if args.dataset == "coco":
        year, split = args.coco_set.split("_", 1)
        view = coco_data.load_coco(os.path.join(args.data_dir, "coco"),
                                   year, split, cache_dir=cache)
        return coco_data.filter_seen(view, args.seen,
                                     cfg.test_categories[0])
    devkit = os.path.join(args.data_dir, "VOCdevkit2007")
    v = voc_data.load_voc(devkit, "2007", "test", cache_dir=cache)
    return voc_data.filter_seen(v, args.seen)


def _prefetched(batches, dev):
    """(host batch, its model inputs on `dev`) in order: the inputs go
    through device_prefetch, the host keeps the pair bookkeeping."""
    host = collections.deque()

    def inputs():
        for b in batches:
            host.append(b)
            yield {k: b[k] for k in INPUTS}

    for dbatch in device_prefetch(inputs(), device=dev):
        yield host.popleft(), dbatch


def run_pass(loader, eval_step, post, args, allowed, dev):
    """One query-shot pass -> all_boxes[class][record_index]."""
    all_boxes = {ci: {} for ci in allowed}
    done = set()
    t0 = time.time()
    n_pairs = len(loader.pairs)
    batches = loader.test_epoch(args.batch_size, num_workers=args.num_workers)
    try:
        for batch, dbatch in _prefetched(batches, dev):
            out = eval_step(dbatch)
            dets, valid = post(out["rois"], out["cls_prob"],
                               out["bbox_pred"], dbatch["im_info"])
            dets, valid = dets.cpu().numpy(), valid.cpu().numpy()
            for i in range(len(batch["pair_index"])):
                pi = int(batch["pair_index"][i])
                if pi in done:
                    continue
                done.add(pi)
                ci = int(batch["category"][i])
                ri = int(batch["record_index"][i])
                all_boxes[ci][ri] = dets[i][valid[i]]
            if len(done) % (50 * args.batch_size) < args.batch_size:
                rate = len(done) / max(time.time() - t0, 1e-9)
                printer(f"  {len(done)}/{n_pairs} pairs ",
                        f"({rate:.1f} pairs/s)")
            if args.debug and len(done) >= 10:
                break
    finally:
        batches.close()
    return all_boxes


def run_fused(loader, fused_step, post, args, allowed, dev):
    """One sweep over unique pairs, all shots at once -> [all_boxes per
    shot].  Pair rows come back pair-major: shot a of unique pair u at row
    u * A + a (train.make_fused_eval_step)."""
    shots = args.average
    by_shot = [{ci: {} for ci in allowed} for _ in range(shots)]
    done = set()
    t0 = time.time()
    u = max(1, args.batch_size // shots)
    printer(f"Shot-fused pass: {u} images x {shots} shots per step")
    batches = loader.test_epoch_fused(u, shots, num_workers=args.num_workers)
    try:
        for batch, dbatch in _prefetched(batches, dev):
            out = fused_step(dbatch)
            dets, valid = post(out["rois"], out["cls_prob"],
                               out["bbox_pred"], out["im_info"])
            dets, valid = dets.cpu().numpy(), valid.cpu().numpy()
            for i in range(len(batch["pair_index"])):
                pi = int(batch["pair_index"][i])
                if pi in done:
                    continue
                done.add(pi)
                ci = int(batch["category"][i])
                ri = int(batch["record_index"][i])
                for a in range(shots):
                    row = i * shots + a
                    by_shot[a][ci][ri] = dets[row][valid[row]]
            if len(done) % (50 * u) < u:
                rate = len(done) * shots / max(time.time() - t0, 1e-9)
                printer(f"  {len(done)}/{len(loader.pairs)} unique pairs "
                        f"({rate:.1f} pairs/s incl. shots)")
            # the same truncation as run_pass: --debug covers the first 10
            # pairs, so the two protocols see the same pairs
            if args.debug and len(done) >= 10:
                break
    finally:
        batches.close()
    return by_shot


def main(argv=None, *,
         imread: Optional[Callable[[str], np.ndarray]] = None) -> list:
    """Evaluate; `imread` reads an image path to an RGB array (the
    loader's default decodes with imageio).  Returns one result dict per
    query-shot pass."""
    args = parse_args(argv)
    cfg = build_config(args)
    check_scope(args, cfg)
    if args.visualization:
        raise SystemExit("--vis: the detection overlays are not ported yet "
                         "(ROADMAP A13b)")
    dev = resolve_device(args.device)
    # adopt train-time architecture knobs saved next to the checkpoint
    # (the reference restores POOLING_MODE from its ckpt dict,
    # test_net_voc.py:277-278)
    run_dir = os.path.dirname(args.checkpoint_path) if args.checkpoint_path \
        else os.path.join(args.save_dir, args.net, args.dataset,
                          args.version)
    cfg_json = os.path.join(run_dir, "config.json")
    if os.path.exists(cfg_json):
        with open(cfg_json) as f:
            saved = json.load(f)
        cfg = cfg.override(["POOLING_MODE", repr(saved["POOLING_MODE"])])
        # adopt the ENTIRE saved model block: evaluating with any
        # architecture knob different from the run's would silently build
        # the wrong model
        known = {f.name for f in dataclasses.fields(cfg.model)}
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, **{k: v for k, v in saved["model"].items()
                          if k in known}))
        printer("Adopted train-time knobs from ", cfg_json)
    view = build_view(args, cfg)
    printer(f"{len(view.records)} eval images, "
            f"{len(view.allowed_classes)} classes under test")

    model = init_weights(AITDetector(cfg, dtype=compute_dtype(cfg)),
                         cfg.RNG_SEED)
    ckpt_dir = args.checkpoint_path or os.path.join(run_dir, "ckpt")
    ckpt_step = 0
    if args.pretrained:
        n_loaded = load_pretrained(model, args.pretrained)
        printer(f"Loaded {n_loaded} converted arrays from ", args.pretrained)
    elif os.path.isdir(ckpt_dir):
        restored = CheckpointManager(ckpt_dir).restore(model)
        if restored is not None:
            ckpt_step = restored[0]
            printer(f"Loaded checkpoint step {ckpt_step} from ", ckpt_dir)
        else:
            printer("WARNING: no checkpoint found, evaluating random init",
                    c="yellow")
    else:
        printer("WARNING: no checkpoint dir, evaluating random init",
                c="yellow")
    model.to(dev).eval()
    eval_step = make_eval_step(model)

    # the reference thresholds at 0.0 (0.05 only under --vis,
    # test_net_voc.py:311-313)
    score_thresh = max(cfg.TEST.SCORE_THRESH, 0.0)

    def post(rois, cls_prob, bbox_pred, im_info):
        return postprocess_detections(
            rois, cls_prob, bbox_pred, im_info, nms_thresh=cfg.TEST.NMS,
            score_thresh=score_thresh, max_per_image=cfg.TEST.MAX_PER_IMAGE,
            bbox_normalize_means=cfg.TRAIN.BBOX_NORMALIZE_MEANS,
            bbox_normalize_stds=cfg.TRAIN.BBOX_NORMALIZE_STDS)

    os.makedirs(args.output_dir, exist_ok=True)
    loader = OneShotLoader(view, cfg, training=False, imread=imread)

    # run tag side-channel (the reference writes it at startup,
    # test_net_voc.py:223-225; the VOC writer reads it back as comp-id)
    comp_id = comp_id_tag(args.checksession, ckpt_step, args.version)
    write_experiment_info(comp_id, os.path.join(args.output_dir,
                                                "experiment.info"))

    fused_boxes = None
    if args.fuse_shots and not (args.average > 1
                                and not args.with_cache_file):
        # don't silently run the per-pass path when the user asked for
        # fusion: at --a 1 fusion is an identity gather (no savings) and
        # --with_cache_file skips inference entirely
        printer("--fuse_shots ignored: ",
                "it needs --a > 1 and no --with_cache_file")
    if args.fuse_shots and args.average > 1 and not args.with_cache_file:
        fused_boxes = run_fused(loader, make_fused_eval_step(model), post,
                                args, view.allowed_classes, dev)

    results = []
    for avg in range(args.average):
        loader.query_position = avg
        tag = (f"sess{args.checksession}_g{args.group}_seen{args.seen}_{avg}"
               if args.group else f"sess{args.checksession}_seen"
                                  f"{args.seen}_{avg}")
        det_file = os.path.join(args.output_dir, tag + ".pkl")
        if args.with_cache_file and os.path.exists(det_file):
            all_boxes = read_data_pickle(det_file)
            printer("Loaded cached detections: ", det_file)
        else:
            if fused_boxes is not None:
                all_boxes = fused_boxes[avg]
            else:
                printer(f"Query-shot pass {avg + 1}/{args.average}")
                all_boxes = run_pass(loader, eval_step, post, args,
                                     view.allowed_classes, dev)
            with open(det_file, "wb") as f:
                pickle.dump(all_boxes, f, pickle.HIGHEST_PROTOCOL)

        if args.dataset == "coco":
            gt = view.coco_gt
            rec_to_img = {i: r.img_id for i, r in enumerate(view.records)}
            dets = dets_to_coco_results(all_boxes, rec_to_img,
                                        gt.class_ind_to_cat_id)
            ev = COCODetEval(gt, dets,
                             img_ids=[r.img_id for r in view.records])
            ev.evaluate()
            ev.accumulate()
            class_index = [c - 1 for c in view.allowed_classes]
            stats = ev.summarize(class_index=class_index)
            results.append({"AP50": float(stats[1]), "AP": float(stats[0])})
        else:
            if args.write_results:
                paths = write_voc_results_files(
                    all_boxes, view.records, view.classes,
                    os.path.join(args.data_dir, "VOCdevkit2007"), "2007",
                    "test", f"{comp_id}_{avg}")
                printer(f"Wrote {len(paths)} devkit result files")
            res = evaluate_voc(
                all_boxes, view.records, view.allowed_classes,
                voc_data.class_order(args.seen))
            printer("  ".join(f"{k}={v * 100:.1f}" for k, v in res.items()))
            results.append(res)

    if results:
        key = "mAP" if args.dataset != "coco" else "AP50"
        mean = float(np.mean([r[key] for r in results]))
        printer(f"Averaged over {len(results)} shots: {key} = "
                f"{mean * 100:.2f}")
    return results


if __name__ == "__main__":
    main()
