"""The uint8 canvas that `predict_prepared` takes is padded with the mean
pixel, as the reference's loader pads it (ait_tpu/data/transforms.py
`place_on_canvas`), so that the device-side normalize maps the padding to
~0, the reference's zero padding in normalized space."""

import numpy as np
import torch

from ait_tpu.data.transforms import place_on_canvas
from ait_tpu_torch import predict
from ait_tpu_torch.models.detector import _to_model_input


def test_fill_value_is_the_reference_loaders():
    im = np.zeros((2, 3, 3), np.uint8)
    canvas = place_on_canvas(im, (4, 5))
    assert canvas.dtype == np.uint8
    assert tuple(int(v) for v in canvas[3, 4]) == predict.CANVAS_FILL
    assert predict.CANVAS_FILL == (124, 116, 104)


def test_mean_filled_canvas_normalizes_to_zero():
    canvas = np.empty((1, 8, 8, 3), np.uint8)
    canvas[:] = predict.CANVAS_FILL
    x = _to_model_input(torch.from_numpy(canvas), torch.float32)
    assert x.abs().max().item() < 0.01
    zero = _to_model_input(torch.zeros((1, 1, 1, 3), dtype=torch.uint8),
                           torch.float32)
    assert zero.abs().min().item() > 1.7          # what zero padding gave
