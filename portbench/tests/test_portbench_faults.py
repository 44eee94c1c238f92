"""The check fails a broken program.  Each test drives a whole run of a
tiny copy of a cell on the CPU (everything but the look for a chip), with
the program's timed path broken underneath, and sees `correct` come out
false under the cell's own limits; the same run unbroken comes out true.
The program runs in float32 here, so a sound run reads far under the
limits, which are set for bf16 on the chip.

Faults: an answer altered where it is produced (a detection's score);
half of the batch left out (its rows answered, or trained, from the other
half's); a training step that leaves the state unchanged; the gradient of
one small leaf (a LayerNorm's scale, a bias) lost; an lr schedule that
decays too early.  A one-chip cell has no exchange between chips to leave
out."""

import importlib
import time

import numpy as np
import pytest

import run as RUN
from benchlib import serve, train
from portbench_cells import tiny_cell


def _correct(kind):
    """A whole run of a tiny cell; a serving window long enough on the CPU
    to reach every batch the check samples (the first two rounds of the
    pool)."""
    cell = tiny_cell(kind)
    cell.cfg["tpu"]["compute_dtype"] = "float32"
    cell.end_to_end = []
    runner = serve if kind == "serve" else train
    seconds = 6.0 if kind == "serve" else 0.3
    out = runner.run(cell, 2 ** 31 + 7, seconds, False, time.monotonic(),
                     device="cpu")
    checks, ok = RUN.checks(cell, out["judged"])
    return ok, checks


def _half(x):
    x = np.array(x, copy=True)
    h = x.shape[0] // 2
    x[h:2 * h] = x[:h]
    return x


def test_sound_serving_is_correct():
    ok, checks = _correct("serve")
    assert ok, checks


def test_an_altered_detection_is_caught(monkeypatch):
    pred = importlib.import_module("ait_tpu_torch.predict")
    orig = pred.postprocess_detections

    def altered(*a, **kw):
        dets, valid = orig(*a, **kw)
        dets = dets.clone()
        dets[0, 0, 4] += 0.01
        return dets, valid

    monkeypatch.setattr(pred, "postprocess_detections", altered)
    ok, checks = _correct("serve")
    assert not ok and checks["det_miss"]["value"] >= 1, checks


def test_half_a_served_batch_left_out_is_caught(monkeypatch):
    pred = importlib.import_module("ait_tpu_torch.predict")
    orig = pred.OneShotPredictor.predict_prepared

    def half(self, canvas, query, im_info):
        return orig(self, _half(canvas), _half(query), _half(im_info))

    monkeypatch.setattr(pred.OneShotPredictor, "predict_prepared", half)
    ok, checks = _correct("serve")
    assert not ok, checks


def test_sound_training_is_correct():
    ok, checks = _correct("train")
    assert ok, checks


def test_a_step_that_leaves_the_state_unchanged_is_caught(monkeypatch):
    state = importlib.import_module("ait_tpu_torch.train.state")
    monkeypatch.setattr(state, "apply_update", lambda *a, **kw: None)
    ok, checks = _correct("train")
    assert not ok and checks["update_gap"]["value"] == pytest.approx(1.0)


def test_half_a_training_batch_left_out_is_caught(monkeypatch):
    state = importlib.import_module("ait_tpu_torch.train.state")
    orig = state.grads_and_metrics

    def half(model, batch, *a, **kw):
        return orig(model, {k: v[:len(v) // 2].repeat(
            2, *([1] * (v.dim() - 1))) for k, v in batch.items()}, *a, **kw)

    monkeypatch.setattr(state, "grads_and_metrics", half)
    ok, checks = _correct("train")
    assert not ok, checks


@pytest.mark.parametrize("leaf", [
    "transformer.dec_layer0.pos_ffn.LayerNorm_0.scale",
    "transformer.dec_layer0.pos_ffn.w_2.bias"])
def test_one_small_leafs_gradient_lost_is_caught(monkeypatch, leaf):
    state = importlib.import_module("ait_tpu_torch.train.state")
    orig = state.grads_and_metrics

    def lost(model, *a, **kw):
        m = orig(model, *a, **kw)
        dict(model.named_parameters())[leaf].grad.zero_()
        return m

    monkeypatch.setattr(state, "grads_and_metrics", lost)
    ok, checks = _correct("train")
    assert not ok and checks["grad_leaf_gap"]["value"] == pytest.approx(
        1.0), checks


def test_a_schedule_that_decays_too_early_is_caught(monkeypatch):
    optim = importlib.import_module("ait_tpu_torch.train.optim")
    monkeypatch.setattr(optim, "lr_schedule",
                        lambda lr, *a, **kw: lambda k: lr * 0.1 ** min(k, 1))
    ok, checks = _correct("train")
    assert not ok and checks["update_gap"]["value"] > 0.5, checks
