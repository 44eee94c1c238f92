"""Logging and metrics: colored printer, meters, metric writers
(counterpart of ait_tpu/utils/logging.py, a copy: the port imports nothing
of ait_tpu).

Metrics always land in a JSONL file (one object a line: "step", "time" and
the metric keys, under "<prefix>/<key>" where a prefix is given);
TensorBoard events are written too when torch.utils.tensorboard is
importable.  The loss decomposition keys (rpn_cls, rpn_box, rcnn_cls,
margin, rcnn_box) are kept.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Optional

_COLORS = {"red": 31, "green": 32, "yellow": 33, "blue": 34,
           "magenta": 35, "cyan": 36}


def color(text: str, c: str = "green") -> str:
    if not sys.stdout.isatty():
        return str(text)
    return f"\033[{_COLORS.get(c, 32)}m{text}\033[0m"


def printer(msg: str, info: str = "", c: str = "green"):
    ts = time.strftime("%Y-%m-%d %H:%M:%S")
    print(f"[{ts}] {color(msg, c)}{info}", flush=True)


class AverageMeter:
    """Running average (lib/ops/utils.py AverageMeter)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class MetricWriter:
    """JSONL + optional TensorBoard scalar writer."""

    def __init__(self, log_dir: str, enable_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if enable_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir)
            except Exception:
                self._tb = None

    def write(self, step: int, metrics: Dict[str, float],
              prefix: Optional[str] = None):
        rec = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            key = f"{prefix}/{k}" if prefix else k
            rec[key] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(key, float(v), int(step))
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class ThroughputMeter:
    """steps/sec + pairs/sec over a sliding window."""

    def __init__(self):
        self._t0 = None
        self._steps = 0
        self._items = 0

    def tick(self, items: int = 1):
        if self._t0 is None:
            self._t0 = time.perf_counter()
            return
        self._steps += 1
        self._items += items

    def rates(self):
        if self._t0 is None or self._steps == 0:
            return 0.0, 0.0
        dt = time.perf_counter() - self._t0
        return self._steps / dt, self._items / dt

    def reset(self):
        self._t0 = None
        self._steps = 0
        self._items = 0
