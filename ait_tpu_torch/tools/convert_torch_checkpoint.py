"""Convert a reference torch checkpoint to a params pickle (counterpart of
tools/convert_torch_checkpoint.py).

    python -m ait_tpu_torch.tools.convert_torch_checkpoint \\
        --input model_best.pth.tar --output res50_backbone.pkl [--kind auto]

Reads, with `torch.load(..., weights_only=True)`:
  * a backbone pretrain, {'state_dict': {'module.conv1.weight': ...}}
    (ResNet), or torchvision / caffe vgg16 ({'features.0.weight': ...});
  * a released detector checkpoint, {'session', 'epoch', 'model':
    state_dict, ...}.
Writes the same pickle as the JAX package's tool: a nested dict of numpy
arrays in the JAX param layout (ait_tpu_torch/convert.py), which
`--pretrained` of the port's CLIs overlays onto a model
(`convert.load_pretrained`; partial trees such as a backbone are fine).
"""

from __future__ import annotations

import argparse
import pickle

import torch

from ait_tpu_torch.convert import (convert_backbone, convert_detector,
                                   convert_vgg_backbone)

CONVERTERS = {"detector": convert_detector, "backbone": convert_backbone,
              "vgg_backbone": convert_vgg_backbone}


def count(tree: dict) -> int:
    return sum(count(v) if isinstance(v, dict) else 1 for v in tree.values())


def convert_file(src: str, kind: str = "auto"):
    """(kind, the converted tree) of the checkpoint at `src`; kind 'auto'
    reads a detector from a dict with 'model', else a backbone (vgg16 when
    its keys are torchvision's `features.*`)."""
    blob = torch.load(src, map_location="cpu", weights_only=True)
    if kind == "auto":
        kind = ("detector" if isinstance(blob, dict) and "model" in blob
                else "backbone")
    sd = blob.get("model") if kind == "detector" else \
        blob.get("state_dict", blob)
    sd = dict(sd)
    if kind == "backbone" and any(
            k.split("module.")[-1].startswith("features.") for k in sd):
        kind = "vgg_backbone"
    return kind, CONVERTERS[kind](sd)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--kind", choices=["auto"] + sorted(CONVERTERS),
                   default="auto")
    args = p.parse_args(argv)
    kind, tree = convert_file(args.input, args.kind)
    with open(args.output, "wb") as f:
        pickle.dump(tree, f, pickle.HIGHEST_PROTOCOL)
    print(f"converted {kind} checkpoint: {count(tree)} arrays -> "
          f"{args.output}")
    return tree


if __name__ == "__main__":
    main()
