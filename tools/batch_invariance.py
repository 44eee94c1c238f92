#!/usr/bin/env python3
"""Where the flagship's eval forward stops being invariant to the pair
batch size, module by module, on one GPU.

    python3 tools/batch_invariance.py [--seed N]

The eval CLI's two protocols run the same pairs at other batch sizes: per
pass `--bs 8` runs B = 8 pairs (8 images, 8 queries), `--fuse_shots --bs 8
--a 2` runs U = 4 unique images and their 8 (image, shot) pair rows.  Here
a batch of 4 seeded pairs (one shot each) goes through the flagship's eval
forward (`Config()`, seeded random weights, TF32 off), once alone and once
as the odd rows of a fused batch of 4 images x 2 shots: the same image and
query inputs, the image backbone at 4 images both times, everything after
it at 4 pair rows against 8.  Forward hooks on every module record the
outputs; for bf16 and f32 it prints the card's name and power limit, then
one JSON line per module whose output differs ({"dtype", "module",
"shape", "max_abs"}, in execution order) and one summary line per dtype.
Checks nothing: chip_smoke.py holds the fused step bit-equal to the
per-pair step at the same pair batch.

Imports nothing of JAX or ait_tpu.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
U, A = 4, 2


def run(torch, model, batch, fused):
    """[(module name, first output tensor)] of one eval forward."""
    rec = []
    hooks = [m.register_forward_hook(
        lambda mod, i, o, n=n: rec.append(
            (n, o[0] if isinstance(o, (tuple, list)) else o)))
        for n, m in model.named_modules() if n]
    image, query, im_info = batch
    try:
        with torch.inference_mode():
            if fused:
                idx = torch.repeat_interleave(
                    torch.arange(U, device=image.device), A)
                model(image, query.reshape((U * A,) + query.shape[2:]),
                      im_info[idx], pair_image_idx=idx)
            else:
                model(image, query, im_info)
    finally:
        for h in hooks:
            h.remove()
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, REPO)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("batch_invariance: no CUDA device", file=sys.stderr)
        return 2
    from ait_tpu_torch.config import Config
    from ait_tpu_torch.models import AITDetector
    from ait_tpu_torch.ops import _build
    from ait_tpu_torch.train import init_weights

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all(["nms", "sh_attention", "sh_attention_general", "ffn",
                      "posln", "gemm", "dropout"])
    dev = torch.device("cuda")
    cfg = Config()
    h, w = cfg.tpu.image_size
    q = cfg.tpu.query_hw
    rng = np.random.RandomState(args.seed)
    image = torch.from_numpy(rng.randint(
        0, 256, (U, h // 2, w // 2, 12)).astype(np.uint8)).to(dev)
    query = torch.from_numpy(rng.randint(
        0, 256, (U, A, q, q, 3)).astype(np.uint8)).to(dev)
    im_info = torch.tensor([[h, w, 1.0]] * U, device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        model = init_weights(AITDetector(cfg, dtype=dtype),
                             cfg.RNG_SEED).to(dev).eval()
        fused = run(torch, model, (image, query, im_info), True)
        pairs = run(torch, model, (image, query[:, 1], im_info), False)
        differ = 0
        for (name, x), (other, y) in zip(fused, pairs):
            if name != other:
                raise SystemExit(f"module order differs: {name}, {other}")
            if not isinstance(x, torch.Tensor):
                continue
            if x.shape[0] == U * A * (y.shape[0] // U) and x.ndim == y.ndim:
                # pair-major rows (or pair-major rois): keep shot 1's
                r = y.shape[0] // U
                x = x.reshape((U, A, r) + x.shape[1:])[:, 1].reshape(y.shape)
            if x.shape != y.shape:
                continue
            d = (x.float() - y.float()).abs().max().item()
            if d != 0:
                differ += 1
                print(json.dumps({"dtype": str(dtype), "module": name,
                                  "shape": list(y.shape), "max_abs": d}),
                      flush=True)
        print(json.dumps({"dtype": str(dtype), "modules": len(pairs),
                          "differ": differ}), flush=True)
        del model
    return 0


if __name__ == "__main__":
    sys.exit(main())
