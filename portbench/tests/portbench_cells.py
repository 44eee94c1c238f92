"""A tiny copy of a cell for the benchmark's CPU tests."""

import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_cell(kind="serve", limits=None):
    """A cell of the flagship's widths and depth on a 64 x 96 canvas with
    few rois, batches of 2: what a CPU test can hold."""
    from benchlib import spec

    with open(os.path.join(BENCH, "configs", "ait_res50_voc.json")) as f:
        conf = json.load(f)
    c = conf["config"]
    c["tpu"]["image_size"] = [64, 96]
    c["TEST"].update(RPN_PRE_NMS_TOP_N=200, RPN_POST_NMS_TOP_N=20)
    c["TRAIN"].update(RPN_PRE_NMS_TOP_N=200, RPN_POST_NMS_TOP_N=40,
                      BATCH_SIZE=16)
    mix = {"kind": kind, "batch": 2, "pool": 3,
           "buckets": [{"canvas": [64, 96], "count": 2},
                       {"canvas": [96, 64], "count": 1}],
           "content_short": 56, "content_long": [60, 90], "scale": 1.6,
           "query": 128, "blocky": 8, "s2d": True, "check": 2,
           "trace_batches": 2, "gt_boxes": [1, 3], "gt_side": [12, 40],
           "max_gt_boxes": 20, "check_steps": 3}
    if limits is None:
        name = "res50_serve_b8" if kind == "serve" else "res50_train_b8"
        with open(os.path.join(BENCH, "checks", name + ".json")) as f:
            limits = json.load(f)
    return spec.Cell("tiny_" + kind, 1, conf, mix, limits, [], [])
