"""The port's logging and profiling helpers (ait_tpu_torch/utils) against
ait_tpu/utils: the same JSONL records, the same meters; `device_trace`
writes a trace on the CPU that holds the spans `annotate` records in it
(the recorder's own tests: tests/test_torch_profiling.py)."""

import json
import os
import time

import pytest
import torch

from ait_tpu.utils import logging as jlog
from ait_tpu_torch.utils import (AverageMeter, MetricWriter, ThroughputMeter,
                                 annotate, device_trace)

METRICS = {"loss": 1.5, "rpn_cls": 0.25, "rpn_box": 0.125, "rcnn_cls": 0.5,
           "margin": 0.375, "rcnn_box": 0.25}


def _records(writer_cls, log_dir):
    w = writer_cls(str(log_dir), enable_tensorboard=False)
    w.write(3, METRICS)
    w.write(3, {"steps_per_sec": 2.0, "pairs_per_sec": 16.0}, prefix="perf")
    w.close()
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_metric_writer_jsonl_matches_jax(tmp_path):
    got = _records(MetricWriter, tmp_path / "port")
    want = _records(jlog.MetricWriter, tmp_path / "jax")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert list(g) == list(w)
        assert {k: v for k, v in g.items() if k != "time"} == \
            {k: v for k, v in w.items() if k != "time"}


def test_metric_writer_appends(tmp_path):
    _records(MetricWriter, tmp_path)
    assert len(_records(MetricWriter, tmp_path)) == 4


@pytest.mark.parametrize("values", [[1.0], [2.0, 4.0, 9.0], [0.5] * 5])
def test_average_meter_matches_jax(values):
    got, want = AverageMeter(), jlog.AverageMeter()
    for i, v in enumerate(values):
        got.update(v, n=i + 1)
        want.update(v, n=i + 1)
    assert (got.val, got.sum, got.count, got.avg) == \
        (want.val, want.sum, want.count, want.avg)
    got.reset()
    assert (got.sum, got.count, got.avg) == (0.0, 0, 0.0)


def test_throughput_meter():
    m = ThroughputMeter()
    assert m.rates() == (0.0, 0.0)
    m.tick(8)                      # the first tick starts the clock
    assert m.rates() == (0.0, 0.0)
    time.sleep(0.01)
    m.tick(8)
    m.tick(8)
    sps, pps = m.rates()
    assert sps > 0 and pps == pytest.approx(8 * sps)
    m.reset()
    assert m.rates() == (0.0, 0.0)


def test_device_trace_and_annotate(tmp_path):
    with device_trace(str(tmp_path)) as prof:
        with annotate("ait_span"):
            torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    names = {e.key for e in prof.key_averages()}
    assert "aten::matmul" in names
    path = tmp_path / "trace.json"
    assert path.exists()
    spans = [e for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "ait_span"]
    assert [e["name"] for e in spans] == ["ait_span"]
