#!/usr/bin/env python3
"""Device time of each kernel of the tiled attention
(csrc/sh_attention_general.cu) and of the mask dump (csrc/dropout.cu) at
the main path's shapes, B = 8, bf16, on one GPU.

    python3 tools/attn_general_bench.py [--repo DIR] [--iters N]
                                        [--out FILE.json]

For the ait_tpu_torch of `--repo` (default: this checkout; e.g. a `git
archive` of an earlier commit, so that two versions are compared in one
call on one card), it times on the device (torch.profiler: every kernel a
call launches, by name, after warm-up; chip_smoke.py's `device_kernels`,
from this checkout):

* the general attention at chip_smoke.py's `ATTN_GENERAL` shapes (the
  co-attention's 1900 x 64 and 64 x 1900 at 8 pairs, 128 x 128 causal and
  96 x 128 padded at 64 pairs) in each mode: the eval forward, the saved
  forward, the backward, and both with dropout from a seed and from
  operand masks; at the 65-128 token shapes also the save-qkv policy's
  forward and backward (dropout from a seed, the train form); each call
  with the kernels it launched (name, launches, ms: the projections and
  weight gradients on csrc/gemm.cu among them);
* the mask dump at the co-attention's 4 dumps of a default train step
  (chip_smoke.py's `COATT_DUMPS`), each alone and their sum, and at the
  FFN's and the glue's dumps of a train step (their sum).

Prints the card's name and power limit first and one JSON line per call.
Checks nothing: chip_smoke.py holds the kernels against their plain
versions.  Imports nothing of JAX or ait_tpu.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEEP = 0.9


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", default=REPO,
                    help="the checkout whose ait_tpu_torch to time")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", help="also write the results here")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))

    import torch

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    if not torch.cuda.is_available():
        print("attn_general_bench: no CUDA device", file=sys.stderr)
        return 2
    from ait_tpu_torch.ops import dropout_masks as dm, fused_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    results = []

    def report(call, shape, fn):
        kernels = {}
        for key, n, ms in cs.device_kernels(fn, args.iters, 2):
            k = kernels.setdefault(cs.kernel_name(key),
                                   {"launches": 0, "ms": 0.0})
            k["launches"] += n
            k["ms"] += ms
        row = {"call": call, "shape": shape,
               "device_ms": sum(k["ms"] for k in kernels.values()),
               "kernels": kernels}
        results.append(row)
        print(json.dumps(row), flush=True)
        return row

    for name, p, tq, tk, kind, _ in cs.ATTN_GENERAL:
        mask = cs._general_mask(torch, dev, tq, tk, kind)
        a = cs._attn_args(torch, dev, p, tq, tk, torch.bfloat16, seed=tq + tk)
        gen = torch.Generator(device="cpu").manual_seed(p + tq + tk)
        g = torch.randn((p, tq, 512), generator=gen).to(dev, torch.bfloat16)
        seed = torch.tensor([12345, -678], dtype=torch.int32, device=dev)
        ak, ok = dm.dropout_keep_masks(seed, p, tq, tk, 512, keep_prob=KEEP)
        shape = f"{name} P={p} {tq}x{tk}"
        report("eval", shape, lambda: fa.fused_sh_attention(*a, mask))
        for mode, drop in (("", {}),
                           (" dropout seed", dict(seed=seed, keep_prob=KEEP)),
                           (" dropout masks", dict(attn_keep=ak, out_keep=ok,
                                                   keep_prob=KEEP))):
            _, oh = fa.fused_sh_attention_saved(*a, mask, **drop)
            report("saved" + mode, shape,
                   lambda: fa.fused_sh_attention_saved(*a, mask, **drop))
            report("bwd" + mode, shape,
                   lambda: fa.fused_sh_attention_bwd(*a, mask, oh, g, **drop))
            del oh
        if fa.fuse_short(tq, tk):
            drop = dict(seed=seed, keep_prob=KEEP)
            _, oh, qkv = fa.fused_sh_attention_saved(*a, mask, save_qkv=True,
                                                     **drop)
            report("saved save-qkv dropout seed", shape,
                   lambda: fa.fused_sh_attention_saved(
                       *a, mask, save_qkv=True, **drop))
            report("bwd save-qkv dropout seed", shape,
                   lambda: fa.fused_sh_attention_bwd(*a, mask, oh, g, qkv=qkv,
                                                     **drop))
            del oh, qkv
        del ak, ok

    seed = cs._seed(torch, dev, 20)
    total = 0.0
    for tag, heads, blocks, length in cs.COATT_DUMPS:
        row = report("keep_mask", f"tag {tag} [{heads}, {blocks}, {length}]",
                     lambda: dm.keep_mask(seed, tag, heads, blocks, length,
                                          KEEP))
        total += row["device_ms"]
    print(json.dumps({"call": "keep_mask co-attention 4 dumps",
                      "device_ms": total}), flush=True)
    rows = 0.0
    for name, fn, n in (("ffn encoder", dm.ffn_keep_mask, cs.B * cs.ROIS * 56),
                        ("ffn decoder", dm.ffn_keep_mask, cs.B * cs.ROIS * 64),
                        ("glue encoder", dm.posln_keep_mask,
                         cs.B * cs.ROIS * 56),
                        ("glue decoder", dm.posln_keep_mask, cs.B * 64)):
        rows += report("keep_mask", f"{name} [{n}, 512]",
                       lambda: fn(seed, n, 512, keep_prob=KEEP))["device_ms"]
    print(json.dumps({"call": "keep_mask FFN and glue dumps of a step",
                      "device_ms": rows}), flush=True)
    resources = {stem: cs.kernel_resources(stem)
                 for stem in ("sh_attention_general", "dropout")}
    for stem, res in resources.items():
        for kernel, use in sorted(res.items()):
            print(f"{stem}: {kernel[:90]}: {use}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "repo": os.path.abspath(args.repo),
                       "calls": results, "keep_mask_4_dumps_ms": total,
                       "keep_mask_rows_dumps_ms": rows,
                       "resources": resources}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
