"""The readings that the limits in portbench/checks/<cell>.json are set
from, for the cells of the serve_shots kind (calibrate.py does the
others'): the program's numbers on many seeds (the lower readings) and the
control's (the upper readings), in one process.

    python3 portbench/calibrate_shots.py --workload coco_nonlocal_serve_b8 \\
        --seeds 101-112 --control-seeds 3 [--out calib.json]

For each seed the program serves the batches that a run would judge
through `predict_prepared` with [U, A, ...] queries, and the reference
judges them as a run does; for the first --control-seeds seeds the control
(reference/coco.py with fp8 product operands) is judged in the program's
place.  The benchmark's own runs do not run this.
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

import calibrate as CAL  # noqa: E402
from benchlib import judge, probes, serve, serve_shots, spec  # noqa: E402
from reference import model as R  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    rows = calibrate_shots(spec.load_cell(args.workload), args)
    CAL.summarize(args, rows)


def calibrate_shots(cell, args):
    from ait_tpu_torch.predict import OneShotPredictor

    cfg, mix, dev = cell.cfg, cell.traffic, args.device
    pc = spec.program_config(cfg)
    dtype = getattr(torch, cfg["tpu"]["compute_dtype"])
    predictor, rows = None, []
    for n, seed in enumerate(CAL.seeds_of(args.seeds)):
        t = time.time()
        W = serve_shots.coco_weights(cfg, seed, dev)
        if predictor is None:
            predictor = OneShotPredictor(pc, W, device=dev, dtype=dtype)
        else:
            predictor.model.load_state_dict(W)
        pool = serve_shots.make_shot_batches(mix, seed)
        sample = serve._sample(mix, seed, [b["image"].shape for b in pool])
        pr, cap = probes.Probes(), probes.Capture()
        cap.install(pr)
        cap.on = True
        for i in sample:
            b = pool[i % len(pool)]
            dets = predictor.predict_prepared(b["image"], b["query"],
                                              b["im_info"])
            cap.records[-1].update(dets=dets, batch=b)
        pr.undo()
        CAL.tf32(False)
        row = {"seed": seed, "program": judge.worst(
            [serve_shots.judge_shots(W, cfg, {**r, **r["batch"]})
             for r in cap.records])}
        if n < args.control_seeds:
            recs = [serve_shots.control_record(W, cfg, pool[i % len(pool)],
                                               R.Prec("fp8"), dev)
                    for i in sample]
            row["fp8"] = judge.worst(
                [serve_shots.judge_shots(W, cfg, {**r, **pool[i % len(pool)]})
                 for r, i in zip(recs, sample)])
        row["seconds"] = time.time() - t
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
