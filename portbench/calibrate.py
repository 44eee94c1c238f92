"""The readings that the limits in portbench/checks/<cell>.json are set
from: the program's numbers on many seeds (the lower readings) and the
control's (the upper readings), in one process.

    python3 portbench/calibrate.py --workload res50_serve_b8 \\
        --seeds 101-112 --control-seeds 3 [--out calib.json]

For each seed the program serves the batches that a run would judge, at the
cell's own sizes, through `OneShotPredictor.predict_prepared` (a training
cell: takes the check steps of `make_train_step`'s step), and the reference
judges them as a run does.  For the first --control-seeds seeds, the
control (the reference with fp8 product operands, put in the program's
place) is judged the same way; in a training cell so is the
fault "half of the batch left out, the mean taken over the rest" (rows
B/2.. replaced by rows 0..B/2 - 1 in the program's step).  The benchmark's
own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch  # noqa: E402

from benchlib import judge, probes, serve, spec, traffic  # noqa: E402
from benchlib import train as btrain  # noqa: E402
from benchlib.weights import make_weights  # noqa: E402
from reference import model as R  # noqa: E402
from reference import train as T  # noqa: E402
from reference.params import frozen, param_shapes  # noqa: E402


def seeds_of(text):
    out = []
    for part in text.split(","):
        if "-" in part:
            a, b = part.split("-")
            out += range(int(a), int(b) + 1)
        elif part:
            out.append(int(part))
    return out


def tf32(on: bool):
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    from ait_tpu_torch.predict import OneShotPredictor

    cell = spec.load_cell(args.workload)
    if cell.traffic["kind"] == "train":
        return calibrate_train(cell, args)
    cfg, mix, dev = cell.cfg, cell.traffic, args.device
    pc = spec.program_config(cfg)
    dtype = getattr(torch, cfg["tpu"]["compute_dtype"])
    shapes = param_shapes(cfg)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    predictor, rows = None, []
    for n, seed in enumerate(seeds_of(args.seeds)):
        t = time.time()
        W = make_weights(shapes, seed, dev)
        if predictor is None:
            predictor = OneShotPredictor(pc, W, device=dev, dtype=dtype)
        else:
            predictor.model.load_state_dict(W)
        pool = traffic.make_batches(mix, seed)
        canvases = [b["image"].shape for b in pool]
        sample = serve._sample(mix, seed, canvases)
        pr, cap = probes.Probes(), probes.Capture()
        cap.install(pr)
        cap.on = True
        for i in sample:
            b = pool[i % len(pool)]
            dets = predictor.predict_prepared(b["image"], b["query"],
                                              b["im_info"])
            cap.records[-1].update(dets=dets, batch=b)
        pr.undo()
        tf32(False)
        row = {"seed": seed, "program": judge.worst(
            [judge.judge_serve(W, cfg, {**r, **r["batch"]})
             for r in cap.records])}
        if n < args.control_seeds:
            recs = [judge.control_record(W, cfg, pool[i % len(pool)],
                                         R.Prec("fp8"), dev)
                    for i in sample]
            row["fp8"] = judge.worst(
                [judge.judge_serve(W, cfg, {**r, **pool[i % len(pool)]})
                 for r, i in zip(recs, sample)])
        tf32(flags[0])
        torch.backends.cudnn.allow_tf32 = flags[1]
        row["seconds"] = time.time() - t
        rows.append(row)
        print(json.dumps(row), flush=True)
    summarize(args, rows)


def summarize(args, rows):
    dev = args.device
    summary = {"workload": args.workload,
               "device": torch.cuda.get_device_name(0)
               if dev == "cuda" else dev,
               "lower": {k: max(r["program"][k] for r in rows)
                         for k in rows[0]["program"]}}
    for kind in ("fp8", "half_batch"):
        got = [r[kind] for r in rows if kind in r]
        if got:
            summary["upper_" + kind] = {k: min(g[k] for g in got)
                                        for k in got[0]}
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)


def _program_steps(cell, seed, batches, dev):
    """The program's check steps from the seed's weights: (records, losses,
    momentum after the first step, parameters after the last)."""
    from ait_tpu_torch.models import AITDetector
    from ait_tpu_torch.train import make_train_step
    from ait_tpu_torch.train.optim import make_optimizer

    cfg = cell.cfg
    pc = spec.program_config(cfg)
    model = AITDetector(pc, dtype=getattr(torch, cfg["tpu"]["compute_dtype"]))
    model.load_state_dict(make_weights(param_shapes(cfg), seed, dev))
    opt = make_optimizer(pc, model)
    step = make_train_step(model, opt, btrain.schedule_of(cell), device=dev)
    gen = torch.Generator(device=dev).manual_seed(btrain.generator_seed(seed))
    pr, cap = probes.Probes(), probes.Capture()
    cap.install(pr)
    cap.on = True
    named = dict(model.named_parameters())
    losses, buf1 = [], None
    for k, batch in enumerate(batches):
        losses.append(float(step(batch, gen)["loss"]))
        if k == 0:
            buf1 = {n: opt.state[p]["momentum_buffer"].clone()
                    for n, p in named.items() if p in opt.state}
    pr.undo()
    params = {n: p.detach().clone() for n, p in named.items()
              if not frozen(n)}
    return cap.records, losses, buf1, params


def _control_steps(cell, seed, batches, prec, dev):
    """The same from the reference at precision `prec` in the program's
    place, on its own proposals."""
    cfg = cell.cfg
    W0 = make_weights(param_shapes(cfg), seed, dev)
    W = {k: v.clone() for k, v in W0.items()}
    recs = []

    def rois_of(k, rpn, info):
        with torch.no_grad():
            r = R.proposals(cfg, rpn, info, train=True)
        recs.append({"rpn_cls": rpn.cls_logits, "rpn_deltas": rpn.deltas,
                     "rois": r})
        return r

    lrs = T.lrs(cell.config["train"], len(batches))
    g = torch.Generator(device=dev).manual_seed(btrain.generator_seed(seed))
    losses, g1, _ = T.run_steps(W, cfg, batches, rois_of, g, lrs,
                                R.Prec(prec))
    sgd = T.SGD(cfg, {})
    buf1 = {k: g1[k] + sgd.decay(k) * W0[k] for k in g1}
    params = {k: W[k] for k in g1}
    return recs, losses, buf1, params


def _half(batch):
    """Rows B/2.. replaced by rows 0..B/2 - 1."""
    out = {}
    for k, v in batch.items():
        h = v.shape[0] // 2
        out[k] = v.copy()
        out[k][h:2 * h] = v[:h]
    return out


def calibrate_train(cell, args):
    dev = args.device
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    n_check = int(cell.traffic["check_steps"])
    rows = []
    for n, seed in enumerate(seeds_of(args.seeds)):
        t = time.time()
        pool = btrain._bucket_first(traffic.make_batches(
            cell.traffic, seed, train=True))[:n_check]
        gseed = btrain.generator_seed(seed)

        def judged(run, detail=None):
            tf32(False)
            got = judge.judge_train(cell, seed, pool, run[0], run[1], run[2],
                                    run[3], gseed, dev, detail)
            torch.backends.cuda.matmul.allow_tf32 = flags[0]
            torch.backends.cudnn.allow_tf32 = flags[1]
            return got

        leaves = {}
        row = {"seed": seed,
               "program": judged(_program_steps(cell, seed, pool, dev),
                                 leaves),
               "worst_leaves": leaves}
        if n < args.control_seeds:
            tf32(False)
            row["fp8"] = judged(_control_steps(cell, seed, pool, "fp8",
                                               dev))
            row["half_batch"] = judged(_program_steps(
                cell, seed, [_half(b) for b in pool], dev))
        row["seconds"] = time.time() - t
        rows.append(row)
        print(json.dumps(row), flush=True)
    summarize(args, rows)


if __name__ == "__main__":
    main()
