"""A serving cell of query shots: one client, closed loop, each batch U
unique images with A query shots each, as test_net's `--fuse_shots` serves
COCO (test_coco.sh --a 4).

The client sends the next batch to `OneShotPredictor.predict_prepared`
with the query as [U, A, q, q, 3] when the last one's U * A detection
arrays have reached the host.  The mix is a serving mix (traffic.py) whose
"batch" is the U * A pairs, with "images" U and "shots" A: the pool's
canvases are traffic.py's, U a batch, and each shot is a crop of its own.
Set-up, the window, the sample judged and the traced windows are
serve.py's, with probes.py's ranges.

The weights are the configuration's (the non-local co-attention when it
names it) drawn as weights.py draws them, but for the co-attention's
GroupNorms: see `coco_weights`.  The check is serve.py's four stages
(judge.py), with reference/coco.py's features in place of model.py's: the
reference runs every pair with its own image backbone pass, so a pair
given another image's features shows in its RPN outputs.
"""

from __future__ import annotations

import gc
import time
from typing import Dict

import numpy as np
import torch

from benchlib import judge, probes, serve, spec, traffic
from benchlib.weights import make_weights
from reference import coco as C
from reference import model as R


def coco_weights(cfg, seed: int, device) -> Dict[str, torch.Tensor]:
    """make_weights over reference/coco.py's leaves, but the co-attention's
    GroupNorm affine, which is scale 1 and bias 0 (torch's GroupNorm
    default).  The model starts it at zero, which makes the non-local
    branch the identity until trained: a fault in it would change nothing
    the check sees."""
    shapes = C.coco_param_shapes(cfg)
    gn = [k for k in shapes if k.rsplit(".", 1)[0] in C.GN_LEAVES]
    out = make_weights({k: v for k, v in shapes.items() if k not in gn},
                       seed, device)
    for k in gn:
        fill = torch.ones if k.endswith(".scale") else torch.zeros
        out[k] = fill(shapes[k], device=device)
    return out


def make_shot_batches(mix: Dict, seed: int):
    """The pool: traffic.py's batches of `images` canvases, each with
    `shots` crops an image as 'query' [U, A, q, q, 3]."""
    u, a = int(mix["images"]), int(mix["shots"])
    if u * a != int(mix["batch"]):
        raise ValueError(f"images x shots is {u * a}, the batch "
                         f"{mix['batch']}")
    pool = traffic.make_batches({**mix, "batch": u}, seed)
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 31]))
    q, block = int(mix["query"]), int(mix["blocky"])
    for b in pool:
        b["query"] = np.stack([traffic._image(rng, q, q, block)
                               for _ in range(u * a)]).reshape(u, a, q, q, 3)
    return pool


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, t0: float,
        device="cuda") -> Dict:
    from ait_tpu_torch.predict import OneShotPredictor

    mix, cfg = cell.traffic, cell.cfg
    # the serving readers of portbench/metrics/ (the backbone's and ROI
    # Align's device time, the rooflines, the device's busy and idle time)
    # read any served batch: to them this cell is a serving cell
    cell.traffic["kind"] = "serve"
    pc = spec.program_config(cfg)
    dtype = getattr(torch, cfg["tpu"]["compute_dtype"])
    weights = coco_weights(cfg, seed, device)
    predictor = OneShotPredictor(pc, weights, device=device, dtype=dtype)
    del weights
    pool = make_shot_batches(mix, seed)
    canvases = [b["image"].shape for b in pool]
    sample = set(serve._sample(mix, seed, canvases))

    pr = probes.Probes()
    cap = probes.Capture()
    cap.install(pr)
    if trace:
        probes.install_ranges(pr, predictor.model)

    def step(i):
        b = pool[i % len(pool)]
        cap.on = i in sample
        dets = predictor.predict_prepared(b["image"], b["query"],
                                          b["im_info"])
        if cap.on:
            cap.records[-1].update(dets=dets, batch=b)
        cap.on = False

    for shape in dict.fromkeys(canvases):
        first = canvases.index(shape)
        for _ in range(2):
            predictor.predict_prepared(pool[first]["image"],
                                       pool[first]["query"],
                                       pool[first]["im_info"])
    serve._sync(device)
    setup_s = time.monotonic() - t0

    out = {"metrics": {}, "device": {}}
    b = int(mix["batch"])
    if not trace:
        lat, i = [], 0
        start = time.perf_counter()
        while True:
            t = time.perf_counter()
            step(i)
            lat.append(time.perf_counter() - t)
            i += 1
            if time.perf_counter() - start >= seconds:
                break
        window = time.perf_counter() - start
        out["attempted"] = b * i
        e2e = {"serve_pairs_per_s": (b * i / window, "pairs/s"),
               "serve_batch_ms_p95": (serve.p95(lat) * 1e3, "ms"),
               "setup_s": (setup_s, "s")}
        for m in cell.end_to_end:
            v, unit = e2e[m["name"]]
            out["metrics"][m["name"]] = {"value": v, "unit": unit}
    else:
        n = int(mix["trace_batches"])
        out.update(serve._traced(step, n, device))
        out["attempted"] = b * out.pop("steps_run")
        from benchlib.counts_shots import shots_flops
        out["flops_per_batch"] = shots_flops(
            cfg, serve._rgb_hw(canvases[0], mix), int(mix["images"]), b,
            cfg["TEST"]["RPN_POST_NMS_TOP_N"])
    out["device"]["memory_peak_bytes"] = serve._peak(device)
    pr.undo()
    del predictor
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out["judged"] = _judge(cap.records, cell, seed, device)
    return out


def _judge(records, cell, seed, device):
    """The worst reading of each compared number over the sampled batches;
    None when no sampled batch completed."""
    if not records:
        return None
    W = coco_weights(cell.cfg, seed, device)
    return judge.worst([judge_shots(W, cell.cfg, {**r, **r["batch"]})
                        for r in records])


def judge_shots(W, cfg, rec: Dict, chunk: int = 2) -> Dict[str, float]:
    """judge.judge_serve's numbers of one served batch of U images and A
    shots each (rec: the batch's 'image' [U, ...], 'query' [U, A, ...],
    'im_info' [U, 3], numpy, and the program's outputs, pair-major), the
    reference's features those of reference/coco.py, every pair with its
    own image backbone pass."""
    dev = rec["rois"].device
    image, query, info = C.pairs(torch.as_tensor(rec["image"], device=dev),
                                 torch.as_tensor(rec["query"], device=dev),
                                 torch.as_tensor(rec["im_info"], device=dev))
    with torch.no_grad():
        feats = C.features(W, cfg, image, query)
        rpn_gap = max(judge._rel_gap(rec["rpn_cls"], feats.rpn.cls_logits),
                      judge._rel_gap(rec["rpn_deltas"], feats.rpn.deltas))
        prog_rpn = R.RPN(rec["rpn_cls"].float(), rec["rpn_deltas"].float())
        rois = R.proposals(cfg, prog_rpn, info, train=False)
        off = (rois - rec["rois"].float()).abs().amax(dim=-1)
        roi_miss = int((off > judge.ROI_TOL_PX).sum())
        h = R.head(W, cfg, feats, rec["rois"].float(), chunk=chunk)
        prob = rec["cls_prob"].float().reshape(h.prob.shape)
        score_gap, box_gap = judge.head_gaps(W, h, prob, rec["bbox_pred"])
        dets, valid = R.postprocess(cfg, rec["rois"].float(), prob,
                                    rec["bbox_pred"].float(), info)
    return {"rpn_gap": rpn_gap, "roi_miss": roi_miss,
            "score_gap": score_gap, "box_gap": box_gap,
            "det_miss": judge.det_miss(rec["dets"], dets, valid)}


def control_record(W, cfg, batch: Dict, prec, device, chunk: int = 2
                   ) -> Dict:
    """What reference/coco.py at precision `prec` produces for a batch, in
    the form `judge_shots` takes: the control put in the program's
    place."""
    with torch.no_grad():
        feats, rois, h, dets, valid = C.detect(
            W, cfg, torch.as_tensor(batch["image"], device=device),
            torch.as_tensor(batch["query"], device=device),
            torch.as_tensor(batch["im_info"], device=device), prec, chunk)
    return {"rpn_cls": feats.rpn.cls_logits, "rpn_deltas": feats.rpn.deltas,
            "rois": rois, "cls_prob": h.prob[..., None],
            "bbox_pred": h.deltas,
            "dets": [dets[i][valid[i]].cpu().numpy()
                     for i in range(dets.shape[0])]}
