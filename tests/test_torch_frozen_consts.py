"""The backbone's frozen constants (models/layers.py::folds,
frozen_consts, conv_bn; models/resnet.py::ResNetBackbone.stem_bn; the
normalisation constants of models/detector.py::_to_model_input), on the
CPU.

With autograd off and the convolutions in bfloat16, each conv + FrozenBN
pair runs as one convolution on a kernel with the BN's scale folded in (in
float32) and a bias, both built once and cached; under grad, and in
float32, the program is the unfolded one, bit for bit.  The BN statistics
are nontrivial (`_randomize_bn`: under init's identity statistics the fold
is a no-op).  Tolerances of the folded bfloat16 program, against the
unfolded float32 program of the port or of ait_tpu: its relative RMS error
at most 1.25x that of the unfolded bfloat16 program of the same package
(the fold drops two roundings a pair; measured 0.7x-0.85x), and elementwise
within 3% of the scale of that unfolded bfloat16 program (measured
0.6-1.9%: a bf16 ulp is 0.4%, over up to 34 pairs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_harness as harness
from ait_tpu.models.resnet import ResNetBackbone as JBackbone
from ait_tpu.models.resnet import ResNetTop as JTop
from ait_tpu_torch import bridge
from ait_tpu_torch.data.transforms import space_to_depth
from ait_tpu_torch.models import detector, layers
from ait_tpu_torch.models.layers import FrozenBatchNorm
from ait_tpu_torch.models.resnet import (ResNetBackbone, ResNetTop,
                                         fold_frozen_bn)
from ait_tpu_torch.utils.profiling import recording
from test_torch_bn_fold import _randomize_bn

PAIRS = {("backbone", "resnet50"): 43, ("backbone", "resnet101"): 94,
         ("top", "resnet50"): 10, ("top", "resnet101"): 10}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _module(kind, variant, dtype=torch.bfloat16, seed=3):
    """(module, its state_dict with random weights and BN statistics)."""
    cls = ResNetBackbone if kind == "backbone" else ResNetTop
    mod = cls(variant, dtype=dtype)
    tree = bridge.random_tree(bridge.jax_shapes(cls(variant)), seed)
    state = _randomize_bn(bridge.to_state_dict(mod, tree), seed)
    mod.load_state_dict(state)
    return mod, state


def _input(kind, planes, seed=2):
    rng = np.random.RandomState(seed)
    if kind == "top":
        return torch.from_numpy(rng.randn(2, 7, 7, 1024).astype("f") * 0.2)
    x = rng.randn(1, 64, 80, 3).astype("f") * 0.5
    return torch.from_numpy(space_to_depth(x) if planes == 12 else x)


def _counts(mod, x):
    """Output and frozen_consts counts of one forward with autograd off."""
    with torch.inference_mode(), recording() as rec:
        y = mod(x)
    return y, rec.counts


def _rel_rms(got, want):
    d = (got.double() - want.double()).norm()
    return float(d / want.double().norm())


def _scaled_close(got, want, rel):
    got, want = got.float().numpy(), want.float().numpy()
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * np.abs(want).max())


MODULES = [("backbone", "resnet50", 3), ("backbone", "resnet50", 12),
           ("backbone", "resnet101", 3), ("backbone", "resnet101", 12),
           ("top", "resnet50", None)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kind,variant,planes", MODULES)
def test_cached_matches_unfolded(kind, variant, planes, dtype):
    mod, state = _module(kind, variant, dtype)
    x = _input(kind, planes)
    unfolded = mod(x).detach()                 # autograd records: unfolded
    got, counts = _counts(mod, x)
    if dtype == torch.float32:                 # float32 never folds
        assert counts == {}
        assert torch.equal(got, unfolded)
        return
    n = PAIRS[(kind, variant)]
    assert counts == {"frozen_consts.built": n}
    again, counts = _counts(mod, x)
    assert counts == {"frozen_consts.reused": n}
    assert torch.equal(again, got)
    ref, _ = _module(kind, variant, torch.float32)
    want = ref(x).detach()
    assert _rel_rms(got, want) <= 1.25 * _rel_rms(unfolded, want)
    _scaled_close(got, unfolded, 3e-2)


@pytest.mark.parametrize("kind,variant,planes", MODULES)
def test_cached_matches_ait_tpu(kind, variant, planes):
    mod, state = _module(kind, variant)
    x = _input(kind, planes)
    jcls = JBackbone if kind == "backbone" else JTop
    params = bridge.to_jax_tree(mod, state)
    want, want16 = (np.array(jax.jit(jcls(variant, dtype=dt).apply)(
        {"params": params}, jnp.asarray(x.numpy())), np.float32)
        for dt in (jnp.float32, jnp.bfloat16))
    want, want16 = torch.from_numpy(want), torch.from_numpy(want16)
    got, counts = _counts(mod, x)
    assert counts == {"frozen_consts.built": PAIRS[(kind, variant)]}
    assert _rel_rms(got, want) <= 1.25 * _rel_rms(want16, want)
    _scaled_close(got, want16, 3e-2)


def _sgd_step(mod, state, x):
    opt = torch.optim.SGD([p for p in mod.parameters() if p.requires_grad],
                          lr=1e-2)
    mod(x).float().square().mean().backward()
    opt.step()


def _reload(mod, state, x):
    mod.load_state_dict(_randomize_bn(state, 7))


def _round_trip(mod, state, x):
    """Out to bfloat16 and back: new storage for every source, which could
    take a freed one's address, but for the cache keeping them alive."""
    def ptrs():
        return {t.data_ptr() for t in [*mod.parameters(), *mod.buffers()]}

    old = ptrs()
    mod.to(torch.bfloat16)
    mod.to(torch.float32)
    assert not old & ptrs()


def _bias_only(mod, state, x):
    """The folded weights, built once as they are; then the switch alone."""
    mod.load_state_dict(fold_frozen_bn(state))
    _counts(mod, x)
    layers.BN_BIAS_ONLY = True


EVENTS = {"optimizer_step": _sgd_step, "load_state_dict": _reload,
          "to_dtype": _round_trip, "bn_bias_only": _bias_only}


@pytest.mark.parametrize("event", list(EVENTS))
def test_a_changed_source_rebuilds(event, monkeypatch):
    """After each event every pair builds again, once, and the output is
    the unfolded program's on the weights as they are then."""
    monkeypatch.setattr(layers, "BN_BIAS_ONLY", False)
    mod, state = _module("top", "resnet50")
    x = _input("top", None)
    first, _ = _counts(mod, x)
    EVENTS[event](mod, state, x)
    got, counts = _counts(mod, x)
    assert counts == {"frozen_consts.built": 10}
    assert _counts(mod, x)[1] == {"frozen_consts.reused": 10}
    layers.BN_BIAS_ONLY = False
    if event == "bn_bias_only":       # the fold computes the same output
        mod.load_state_dict(state)
    want = mod(x).detach()            # unfolded
    _scaled_close(got, want, 3e-2)
    if event in ("optimizer_step", "load_state_dict"):
        # the output moved by 18-82%, far past the bf16 error (~0.4%)
        assert _rel_rms(got, want) < 0.1 * _rel_rms(first, want)


def _all_counts(rec):
    counts = dict(rec.counts)
    for s in rec.spans:
        for k, v in s.counts.items():
            counts[k] = counts.get(k, 0) + v
    return counts


def test_the_detectors_second_forward_rebuilds_nothing():
    """The tiny flagship's eval forward, the image in 12 planes and the
    query in 3: the stem keeps a kernel for each form.  The backbone runs
    on the image and the query, the top on the rois and the query: the
    first forward builds each pair once and the stem's second form."""
    _, _, _, pcfg, pmodel = harness.flagship()
    model = type(pmodel)(pcfg, dtype=torch.bfloat16).eval()
    model.load_state_dict(_randomize_bn(pmodel.state_dict(), 5))
    image, query, info = harness.batch(2)
    args = (torch.from_numpy(space_to_depth(image)),
            torch.from_numpy(query), torch.from_numpy(info))
    pairs = PAIRS[("backbone", "resnet50")] + PAIRS[("top", "resnet50")]
    n = 2 * pairs
    keys = list(model.state_dict())
    with torch.inference_mode():
        with recording() as rec:
            first = model(*args)
        # ROI Align of CPU tensors takes its plain version, one count a roi
        rois = {"roi_align.plain_rois": first.rois.shape[0] *
                first.rois.shape[1]}
        assert _all_counts(rec) == {"frozen_consts.built": pairs + 1,
                                    "frozen_consts.reused": n - pairs - 1,
                                    **rois}
        with recording() as rec:
            again = model(*args)
        assert _all_counts(rec) == {"frozen_consts.reused": n, **rois}
    for a, b in zip(first[:3], again[:3]):
        assert torch.equal(a, b)
    assert list(model.state_dict()) == keys     # the cache is no state


def test_grad_never_reads_the_cache():
    """Under grad the pairs run unfolded: with every cached kernel and bias
    poisoned, the loss and the gradients are bitwise a fresh module's."""
    x = _input("backbone", 12)
    mods = [_module("backbone", "resnet50")[0] for _ in range(2)]
    _counts(mods[0], x)
    bns = [m for m in mods[0].modules() if isinstance(m, FrozenBatchNorm)]
    for bn in bns:
        for form, (key, kernel, bias, keep) in list(bn.folded.items()):
            bn.folded[form] = (key, torch.full_like(kernel, float("nan")),
                               torch.full_like(bias, float("nan")), keep)
    with torch.inference_mode():            # the poison is what it reads
        assert torch.isnan(mods[0](x)).all()
    out = []
    for m in mods:
        loss = m(x).float().square().mean()
        loss.backward()
        out.append((loss.detach(), [p.grad for p in m.parameters()
                                    if p.requires_grad]))
    (l0, g0), (l1, g1) = out
    assert torch.isfinite(l0) and torch.equal(l0, l1)
    assert len(g0) == len(g1) > 0
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_normalisation_constants_are_built_once_per_device_and_planes():
    detector._norm_consts.cache_clear()
    rng = np.random.RandomState(0)
    x3 = rng.randint(0, 256, (2, 6, 8, 3)).astype(np.uint8)
    x12 = space_to_depth(x3)
    with torch.inference_mode():       # built here, read under grad below
        for x in (x3, x12, x3, x12):
            detector._to_model_input(torch.from_numpy(x), torch.float32)
    info = detector._norm_consts.cache_info()
    assert (info.misses, info.currsize) == (2, 2)
    cpu = torch.device("cpu")
    mean, std = detector._norm_consts(cpu, 4)
    assert detector._norm_consts(cpu, 4)[0] is mean
    assert not mean.is_inference() and not std.is_inference()
    for x in (x3, x12):                # the arithmetic is unchanged
        t = torch.from_numpy(x)
        reps = x.shape[-1] // 3
        want = (t.float() / 255.0 -
                torch.tensor(detector._NORM_MEAN * reps)) / \
            torch.tensor(detector._NORM_STD * reps)
        assert torch.equal(detector._to_model_input(t, torch.float32), want)


def test_inference_tensor_weights_are_folded_every_call():
    """A module built inside inference_mode holds inference tensors, which
    keep no version counter: each forward folds anew, and agrees."""
    mod, state = _module("top", "resnet50")
    x = _input("top", None)
    want, _ = _counts(mod, x)
    with torch.inference_mode():
        inf = ResNetTop("resnet50", dtype=torch.bfloat16)
        inf.load_state_dict(state)
    for _ in range(2):
        got, counts = _counts(inf, x)
        assert counts == {"frozen_consts.built": 10}
        assert torch.equal(got, want)
