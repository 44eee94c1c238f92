"""The check of the serve_shots cell fails a broken program.  Each test
drives a whole run of a tiny copy of the cell on the CPU (the program in
float32), with the program broken underneath, and sees `correct` come out
false under the cell's own limits; the same run unbroken comes out true.

Fault: a pair given the features of another image than its own (the
shot-fused gather)."""

import importlib
import time

import run as RUN
from benchlib import serve_shots
from portbench_shots import tiny_shots_cell


def _shots_correct():
    cell = tiny_shots_cell()
    out = serve_shots.run(cell, 2 ** 31 + 7, 4.0, False, time.monotonic(),
                          device="cpu")
    return RUN.checks(cell, out["judged"])[::-1]


def test_sound_shot_serving_is_correct():
    ok, checks = _shots_correct()
    assert ok, checks


def test_a_pair_given_another_images_features_is_caught(monkeypatch):
    det = importlib.import_module("ait_tpu_torch.models.detector")
    orig = det.AITDetector.forward

    def crossed(self, image, *a, pair_image_idx=None, **kw):
        if pair_image_idx is not None:
            pair_image_idx = (pair_image_idx + 1) % image.shape[0]
        return orig(self, image, *a, pair_image_idx=pair_image_idx, **kw)

    monkeypatch.setattr(det.AITDetector, "forward", crossed)
    ok, checks = _shots_correct()
    assert not ok and checks["rpn_gap"]["value"] > 0.2, checks
