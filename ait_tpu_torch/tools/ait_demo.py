"""Standalone demo of the Adaptive Image Transformer module (counterpart of
tools/ait_demo.py).

    python -m ait_tpu_torch.tools.ait_demo [--device cpu]

Runs the AIT encoder-decoder, one layer at 1024 channels with the weights
ait_tpu initializes (`train.init_module`, seed 0), on numpy seed 0's normal
tensors and prints the shape contract: [bs*P, 7, 7, 1024] proposals x
[bs, 8, 8, 1024] query -> [bs*P, 8, 8, 1024] translated proposal features.
Runs on the GPU unless `--device` names another.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ait_tpu_torch.device import resolve_device
from ait_tpu_torch.models.ait_transformer import AITTransformer
from ait_tpu_torch.train import init_module

BS, NUM_PROPS = 2, 128


def main(argv=None) -> torch.Tensor:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' to run on "
                        "the CPU)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.RandomState(0)
    x_props = torch.from_numpy(
        rng.randn(BS * NUM_PROPS, 7, 7, 1024).astype(np.float32)).to(dev)
    x_query = torch.from_numpy(
        rng.randn(BS, 8, 8, 1024).astype(np.float32)).to(dev)

    model = init_module(AITTransformer(n_layers=1, channels=1024), 0)
    model.to(dev).eval()
    with torch.inference_mode():
        out = model(x_props, x_query)
    print(f"x_props  {tuple(x_props.shape)}")
    print(f"x_query  {tuple(x_query.shape)}")
    print(f"output   {tuple(out.shape)}  (proposal features translated "
          f"into the query grid)")
    assert out.shape == (BS * NUM_PROPS, 8, 8, 1024)
    print("ok")
    return out


if __name__ == "__main__":
    main()
