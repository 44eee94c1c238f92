"""NMS on the input the flagship's proposal layer produces, on the CPU.

chip_smoke.py times csrc/nms.cu on two inputs: random boxes
(`synthetic_nms_boxes`) and the flagship's own proposals
(`model_nms_boxes`: its 17,100 anchors decoded with small seeded deltas,
clipped, in a seeded score order).  The second is what the model sweeps:
overlapping clusters whose survivors come slowly, so the sweep walks many
more tiles before it reaches its cap.  Here:

* the port's plain sweep on that input keeps bit-equal selections to
  ait_tpu's XLA sweep (`ait_tpu.ops.nms.nms_keep_mask`) and to its Pallas
  kernel in interpret mode, at the three calls of the model (eval 6144 ->
  300 at 0.7, the postprocess 300 -> 300 at 0.3, train 12032 -> 2000 at
  0.7);
* at the train call it walks at least 3x the synthetic input's tiles, so
  that chip_smoke keeps timing the expensive regime;
* with a stand-in for the built library, the kernel wrapper's arguments
  at each call's shape (the survivor cap and its padding), one launch
  counted per call, a cap beyond the kernel's shared memory refused, and
  no kernel for a CPU tensor.
"""

import importlib
import importlib.util
import os

import numpy as np
import pytest
import torch

from ait_tpu_torch.ops import _build

# the module (ait_tpu_torch.ops exports its `nms` function under that name)
pnms = importlib.import_module("ait_tpu_torch.ops.nms")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALLS = [(6144, 0.7, 300), (300, 0.3, 300), (12032, 0.7, 2000)]


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def selections(keep, cap):
    keep = np.asarray(keep)
    return [np.where(row)[0][:cap].tolist() for row in keep]


@pytest.mark.parametrize("n,thr,cap", CALLS)
def test_plain_sweep_on_model_input_matches_jax(n, thr, cap):
    jnp = pytest.importorskip("jax.numpy")
    from ait_tpu.ops.nms import nms_keep_mask as jax_keep
    from ait_tpu.ops.nms_pallas import nms_keep_mask_batched as pallas_keep

    boxes, valid = chip_smoke().model_nms_boxes(torch, n, seed=n, images=2)
    got = selections(pnms.nms_keep_mask_batched(boxes, valid, thr,
                                                max_out=cap), cap)
    jb, jv = jnp.asarray(boxes.numpy()), jnp.asarray(valid.numpy())
    xla = [np.asarray(jax_keep(jb[i], jv[i], thr, tile=256, max_out=cap))
           for i in range(2)]
    assert got == selections(xla, cap)
    pallas = pallas_keep(jb, jv, thr, tile=256, max_out=cap, interpret=True)
    assert got == selections(pallas, cap)
    # both images keep survivors, and the decoded proposals overlap
    assert all(len(s) > 0 for s in got)


def test_model_input_walks_three_times_the_tiles():
    cs = chip_smoke()
    n, thr, cap = CALLS[2]
    g = torch.Generator(device="cpu").manual_seed(1)
    for m, _, _ in CALLS[:2]:          # chip_smoke's order of draws
        cs.synthetic_nms_boxes(torch, g, m)
    walked = {}
    for what, (boxes, valid) in (
            ("synthetic", cs.synthetic_nms_boxes(torch, g, n)),
            ("model", cs.model_nms_boxes(torch, n, seed=n))):
        keep = pnms.nms_keep_mask_reference(boxes, valid, thr, max_out=cap)
        tiles, tests = cs.nms_walk(keep, n, cap)
        assert len(tiles) == len(tests) == cs.B
        walked[what] = (sum(tiles), sum(tests))
    assert walked["model"][0] >= 3 * walked["synthetic"][0], walked
    assert walked["model"][1] >= 3 * walked["synthetic"][1], walked


def test_model_input_shape_and_validity():
    cs = chip_smoke()
    boxes, valid = cs.model_nms_boxes(torch, 12032, seed=3, images=2)
    assert boxes.shape == (2, 12032, 4) and boxes.dtype == torch.float32
    assert valid.shape == (2, 12032) and valid.dtype == torch.bool
    assert int(valid[0].sum()) == 12000
    assert float(boxes[..., :2].min()) >= 0
    assert float(boxes[..., 2].max()) <= 799
    assert float(boxes[..., 3].max()) <= 607
    # image 0 is the anchors themselves (deltas 0), image 1 moved
    again, _ = cs.model_nms_boxes(torch, 12032, seed=3, images=2)
    assert torch.equal(boxes, again)
    assert not torch.equal(boxes[0], boxes[1])


# ------------------------------------------------------- launches, faked


class FakeLibrary:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.mark.parametrize("n,thr,cap,cap_pad",
                         [(600, 0.7, 100, 128), (6144, 0.7, 300, 384),
                          (300, 0.3, 300, 384), (12032, 0.7, 2000, 2048)])
def test_nms_launch_passes_cap(n, thr, cap, cap_pad, monkeypatch):
    """The launch the wrapper makes for a CUDA tensor (`_launch` on the
    checked operands; here CPU tensors and a stand-in library).  The
    cluster size is the kernel's own constant, not an argument."""
    lib = FakeLibrary()
    monkeypatch.setattr(_build, "load", lambda stem, funcs: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    boxes = torch.rand(3, n, 4)
    valid = torch.ones(3, n, dtype=torch.bool)
    before = pnms.nms_keep_mask_batched.launches
    keep = pnms._launch(boxes, valid, thr, cap)
    assert keep.shape == (3, n) and keep.dtype == torch.bool
    assert pnms.nms_keep_mask_batched.launches == before + 1
    assert [name for name, _ in lib.calls] == ["nms_keep_mask"]
    a = lib.calls[0][1]
    assert len(a) == len(pnms._FUNCS["nms_keep_mask"]) == 9
    assert a[0] == boxes.data_ptr() and a[1] == valid.data_ptr()
    assert a[3:5] == (3, n)
    assert a[5] == pytest.approx(thr)
    assert a[6:8] == (cap, cap_pad)                # cap, rounded up to 128
    assert a[8] == 0


def test_nms_refuses_a_cap_beyond_shared_memory(monkeypatch):
    """Each of an image's 16 blocks holds 1/16 of the padded survivor cap
    in up to 160 KB of shared memory: 163,840 survivors fit, one more
    padding step does not, and nothing is launched."""
    lib = FakeLibrary()
    monkeypatch.setattr(_build, "load", lambda stem, funcs: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    boxes = torch.zeros(1, 163841, 4)
    valid = torch.ones(1, 163841, dtype=torch.bool)
    pnms._launch(boxes, valid, 0.7, 163840)
    with pytest.raises(ValueError, match="shared memory"):
        pnms._launch(boxes, valid, 0.7, 163841)
    assert len(lib.calls) == 1


def test_nms_cpu_tensor_never_builds_a_kernel(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda *a, **k: pytest.fail(
        "a CPU tensor built a kernel"))
    before = pnms.nms_keep_mask_batched.launches
    keep = pnms.nms_keep_mask_batched(torch.rand(2, 300, 4),
                                      torch.ones(2, 300, dtype=torch.bool),
                                      0.5, max_out=50)
    assert keep.device.type == "cpu" and keep.shape == (2, 300)
    assert pnms.nms_keep_mask_batched.launches == before
