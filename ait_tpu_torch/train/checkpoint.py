"""Checkpoints with resume (counterpart of ait_tpu/train/checkpoint.py,
which saves through orbax; the port writes torch files of its own and
reads no orbax checkpoint).

A checkpoint is the directory `<directory>/<step>/` holding `state.pt`
(the model's and the optimizer's `state_dict`s and the step) and
`metadata.json`.  It is written under a temporary name in the same
directory, flushed to disk, and renamed into place with `os.replace`, so a
run killed in the middle of a save leaves no directory that `latest_step`
takes for a checkpoint: the preemption safety orbax gives the JAX package.
Only the `max_to_keep` newest steps are kept.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import shutil
from typing import List, Optional, Tuple

import torch

from ait_tpu_torch.config import Config

_TMP = ".tmp-"


def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _device_of(model: torch.nn.Module) -> torch.device:
    for t in itertools.chain(model.parameters(), model.buffers()):
        return t.device
    return torch.device("cpu")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isfile(
                          os.path.join(self.directory, n, "state.pt")))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, model: torch.nn.Module,
             optimizer: Optional[torch.optim.Optimizer] = None, *,
             metadata: Optional[dict] = None, force: bool = False) -> bool:
        """Write step `step`; returns whether it did.  As orbax decides:
        without `force` a step not above the latest saved one is skipped.
        A step already saved is never rewritten (orbax raises on `force`
        there; the state of one step is one state, so the port skips)."""
        latest = self.latest_step()
        if step in self.all_steps() or (
                not force and latest is not None and step <= latest):
            return False
        # what a killed save left behind; a reader (OneShotPredictor.from_run
        # during a run) never deletes, the writer does
        for name in os.listdir(self.directory):
            if name.startswith(_TMP):
                shutil.rmtree(os.path.join(self.directory, name))
        tmp = os.path.join(self.directory, f"{_TMP}{step}-{os.getpid()}")
        os.makedirs(tmp)
        state = {"step": int(step), "model": model.state_dict(),
                 "optimizer": (optimizer.state_dict()
                               if optimizer is not None else None)}
        files = (os.path.join(tmp, "state.pt"),
                 os.path.join(tmp, "metadata.json"))
        torch.save(state, files[0])
        with open(files[1], "w") as f:
            json.dump(metadata or {}, f)
        for path in files + (tmp,):
            _fsync(path)
        os.replace(tmp, os.path.join(self.directory, str(step)))
        _fsync(self.directory)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))
        return True

    def restore(self, model: torch.nn.Module,
                optimizer: Optional[torch.optim.Optimizer] = None,
                step: Optional[int] = None) -> Optional[Tuple[int, dict]]:
        """Load step `step` (the latest by default) into `model` and, if
        given, `optimizer`; returns (step, metadata), or None when there is
        no checkpoint.  Tensors land on the model's device."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        path = os.path.join(self.directory, str(step))
        state = torch.load(os.path.join(path, "state.pt"), weights_only=True,
                           map_location=_device_of(model))
        model.load_state_dict(state["model"])
        if optimizer is not None:
            if state["optimizer"] is None:
                raise ValueError(f"checkpoint {path} holds no optimizer "
                                 "state")
            optimizer.load_state_dict(state["optimizer"])
        with open(os.path.join(path, "metadata.json")) as f:
            metadata = json.load(f)
        return int(state["step"]), metadata

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for (orbax's may not be)."""

    def close(self) -> None:
        """Nothing stays open between calls."""


def save_config(directory: str, cfg: Config) -> None:
    """`<directory>/config.json`, the same JSON as the JAX package writes."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2, default=list)
