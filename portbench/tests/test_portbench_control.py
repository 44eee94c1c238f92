"""The control comes out not correct (on the card).  The control is the
reference computed with fp8 (e4m3) product operands, one step below the
configuration's bf16, put in the program's place and judged as a run
judges the program, under each cell's own limits.  Here at the cells'
widths, depth and canvases with batches of 2 (a test run's size); the
readings at the cells' own size, on more seeds, are calibrate.py's.

    python -m pytest -m gpu portbench/tests
"""

import pytest
import torch

from benchlib import judge, spec, traffic
from benchlib import train as btrain
from benchlib.weights import make_weights
from reference import model as R
from reference.params import param_shapes

SEEDS = (901, 902, 903)


def _small(cell):
    mix = dict(cell.traffic, batch=2, pool=2)
    kept = mix["buckets"][:2]
    mix["buckets"] = [dict(k, count=2 // len(kept)) for k in kept]
    mix["check"] = 2
    cell.traffic = mix
    return cell


def _over(cell, got):
    return [k for k, lim in cell.limits.items() if got[k] > lim]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["res50_serve_b8", "res101ls_serve_b8"])
def test_serving_control_is_not_correct(gpu, name):
    cell = _small(spec.load_cell(name))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in SEEDS:
        W = make_weights(param_shapes(cell.cfg), seed, gpu)
        pool = traffic.make_batches(cell.traffic, seed)
        for b in pool:
            rec = judge.control_record(W, cell.cfg, b, R.Prec("fp8"), gpu)
            got = judge.judge_serve(W, cell.cfg, {**rec, **b})
            assert _over(cell, got), got


@pytest.mark.gpu
def test_training_control_is_not_correct(gpu):
    import calibrate

    cell = _small(spec.load_cell("res50_train_b8"))
    n = int(cell.traffic["check_steps"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in SEEDS:
        pool = btrain._bucket_first(traffic.make_batches(
            cell.traffic, seed, train=True))
        pool = (pool * n)[:n]
        run = calibrate._control_steps(cell, seed, pool, "fp8", gpu)
        got = judge.judge_train(cell, seed, pool, *run,
                                btrain.generator_seed(seed), gpu)
        assert _over(cell, got), got
