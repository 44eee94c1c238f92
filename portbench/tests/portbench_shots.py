"""A tiny copy of the serve_shots cell for the benchmark's CPU tests: the
COCO configuration's widths and depth on a 64 x 96 canvas with few rois,
in float32."""

import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_shots_cell():
    """ait_res50_coco under a mix of 2 images x 2 shots a batch."""
    from benchlib import spec

    with open(os.path.join(BENCH, "configs", "ait_res50_coco.json")) as f:
        conf = json.load(f)
    c = conf["config"]
    c["tpu"]["image_size"] = [64, 96]
    c["tpu"]["compute_dtype"] = "float32"
    c["TEST"].update(RPN_PRE_NMS_TOP_N=200, RPN_POST_NMS_TOP_N=20)
    with open(os.path.join(BENCH, "checks",
                           "coco_nonlocal_serve_b8.json")) as f:
        limits = json.load(f)
    mix = {"kind": "serve_shots", "batch": 4, "images": 2, "shots": 2,
           "pool": 3, "buckets": [{"canvas": [64, 96], "count": 2},
                                  {"canvas": [96, 64], "count": 1}],
           "content_short": 56, "content_long": [60, 90], "scale": 1.25,
           "query": 128, "blocky": 8, "s2d": True, "check": 2,
           "trace_batches": 2}
    return spec.Cell("tiny_shots", 1, conf, mix, limits, [], [])
