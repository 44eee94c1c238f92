#!/usr/bin/env python3
"""Device time of the LayerNorm glue's kernels (csrc/posln.cu) at the
flagship's main-path shapes, B = 8, bf16, on one GPU.

    python3 tools/posln_bench.py [--repo DIR] [--iters N] [--out FILE.json]

For the ait_tpu_torch of `--repo` (default: this checkout; e.g. a `git
archive` of an earlier commit, so that two versions are compared in one
call on one card), it times on the device (torch.profiler: the summed
time of every kernel a call launches, after warm-up; a CUDA-event time of
a 512-row call would measure its wrapper's host work):

* `fused_posln` at the eval forward's two calls (134,400 and 512 rows, no
  dropout) and the train step's (57,344 and 512 rows, dropout 0.1 from a
  seed);
* `fused_posln_bwd` at the train step's two calls, with and without
  dropout;
* `_ln_bwd` in the FFN backward's mode (bf16 x and g, f32 addend y2, f32
  dy and dy2) at the train step's two FFN calls (57,344 and 65,536 rows),
  with and without dropout;

each with the kernels it launched (name, launches, ms), and beside them a
yardstick: one PyTorch LayerNorm call (eps 1e-6) on the already-summed
rows, `F.layer_norm` forward or aten's native_layer_norm_backward (the
timing and the yardstick are chip_smoke.py's `device_kernels` and
`layer_norm_yardstick`, from this checkout).  Prints
the card's name and power limit first and one JSON line per call.  Checks
nothing: chip_smoke.py holds the kernels against their plain versions.

Imports nothing of JAX or ait_tpu.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, ROIS, D, KEEP = 8, 128, 512, 0.9


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", default=REPO,
                    help="the checkout whose ait_tpu_torch to time")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--out", help="also write the results here")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))

    import torch

    # this checkout's chip_smoke.py, whatever checkout --repo names
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    if not torch.cuda.is_available():
        print("posln_bench: no CUDA device", file=sys.stderr)
        return 2
    from ait_tpu_torch.models.layers import sinusoid_table
    from ait_tpu_torch.ops import fused_ffn as ff, philox

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    seed = torch.tensor([12345, -678], dtype=torch.int32, device=dev)
    bf = torch.bfloat16

    def rn(*shape, dtype=bf):
        return torch.randn(*shape, generator=g).to(dev, dtype)

    def device_ms(fn):
        kernels = [{"name": k[:100], "launches": n, "ms": ms}
                   for k, n, ms in chip_smoke.device_kernels(fn, args.iters,
                                                             3)]
        return sum(k["ms"] for k in kernels), kernels

    def yardstick(y, gy=None):
        return chip_smoke.layer_norm_yardstick(torch, y, gy)

    ln_s = 1 + rn(D, dtype=torch.float32) * 0.1
    ln_b = rn(D, dtype=torch.float32) * 0.1
    drop_args = (seed.data_ptr(), philox.keep_threshold(KEEP), 1.0 / KEEP)
    results = []

    def report(name, n, ms, kernels, yard):
        row = {"call": name, "rows": n, "device_ms": ms,
               "yardstick_ms": yard, "kernels": kernels}
        results.append(row)
        print(json.dumps(row), flush=True)

    glue = (("posln eval", 300 * B * 56, 56, False),
            ("posln eval", B * 64, 64, False),
            ("posln train dropout", B * ROIS * 56, 56, True),
            ("posln train dropout", B * 64, 64, True))
    for name, n, t, drop in glue:
        x = rn(n, D)
        pos = torch.from_numpy(sinusoid_table(64, D)[:t]).to(dev, bf)
        kw = dict(seed=seed, keep_prob=KEEP) if drop else {}
        ms, kernels = device_ms(lambda: ff.fused_posln(x, pos, ln_s, ln_b,
                                                       **kw))
        y = (x.float() + pos.float().repeat(n // t, 1)).to(bf)
        report(name, n, ms, kernels, yardstick(y))
        if not drop:
            continue
        gy = rn(n, D)               # the train shapes: the backward too
        for bname, bkw in (("posln_bwd train", {}),
                           ("posln_bwd train dropout", kw)):
            ms, kernels = device_ms(lambda: ff.fused_posln_bwd(
                x, pos, ln_s, ln_b, gy, **bkw))
            report(bname, n, ms, kernels, yardstick(y, gy))
    for n in (B * ROIS * 56, B * ROIS * 64):
        x, y2, gy = rn(n, D), rn(n, D, dtype=torch.float32), rn(n, D)
        for name, mode, drop in (("ln_bwd ffn", ff._LN_PLAIN, (None, 0, 1.0)),
                                 ("ln_bwd ffn dropout", ff._LN_FFN,
                                  drop_args)):
            ms, kernels = device_ms(lambda: ff._ln_bwd(
                x, y2, n, ln_s, gy, torch.float32, mode, drop))
            report(name, n, ms, kernels, yardstick(x.float() + y2, gy))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "repo": os.path.abspath(args.repo),
                       "calls": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
