"""The port stands alone: no module of ait_tpu_torch, and none of
chip_smoke.py, tools/port_profile.py, tools/posln_bench.py and
tools/attn_general_bench.py, imports JAX,
flax, optax or the JAX package, or unpickles without a class filter; its
entry points refuse to run quietly on the CPU when no GPU is there."""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ait_tpu")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py"),
           os.path.join(REPO, "tools", "port_profile.py"),
           os.path.join(REPO, "tools", "posln_bench.py"),
           os.path.join(REPO, "tools", "attn_general_bench.py")]
    for root, _, files in os.walk(os.path.join(REPO, "ait_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name):
    # exact module or a submodule of it: "ait_tpu_torch" is not "ait_tpu"
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_sources_found():
    assert len(_sources()) >= 20


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_imports(path):
    bad = [n for n in _imported(path) if _forbidden(n)]
    assert not bad, f"{path} imports {bad}"


def _unpickling_calls(path):
    """Calls that unpickle without a class filter: pickle.load(s),
    pickle.Unpickler(...).load() through the plain class, numpy loads that
    allow pickles."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        name = ast.unparse(f)
        if name in ("pickle.load", "pickle.loads", "pickle.Unpickler"):
            yield f"{name} at line {node.lineno}"
        if name.endswith(("np.load", "numpy.load")) and any(
                k.arg == "allow_pickle" for k in node.keywords):
            yield f"{name}(allow_pickle=...) at line {node.lineno}"


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_unfiltered_unpickling(path):
    """The port reads no pickle through an unpickler that would build any
    class (a JAX package cache holds ait_tpu classes): data/coco.py's
    reference-image file goes through its builtins-and-numpy unpickler."""
    bad = list(_unpickling_calls(path))
    assert not bad, f"{path}: {bad}"


def test_forbidden_match_is_exact():
    assert _forbidden("ait_tpu") and _forbidden("ait_tpu.ops.nms")
    assert _forbidden("jax.numpy") and not _forbidden("jaxtyping_free")
    assert not _forbidden("ait_tpu_torch.ops.nms")


def test_importing_the_port_loads_no_jax():
    code = ("import sys, ait_tpu_torch, ait_tpu_torch.predict, "
            "ait_tpu_torch.bridge, ait_tpu_torch.ops.nms, "
            "ait_tpu_torch.ops.fused_attention, ait_tpu_torch.ops.fused_ffn, "
            "ait_tpu_torch.ops._gemm, ait_tpu_torch.ops.philox, "
            "ait_tpu_torch.ops.dropout_masks, ait_tpu_torch.models.dropout, "
            "ait_tpu_torch.models.targets, "
            "ait_tpu_torch.models.losses, ait_tpu_torch.train.optim, "
            "ait_tpu_torch.train.state, ait_tpu_torch.data, "
            "ait_tpu_torch.data.voc, ait_tpu_torch.data.coco, "
            "ait_tpu_torch.evaluation.voc_eval, "
            "ait_tpu_torch.evaluation.voc_results, "
            "ait_tpu_torch.evaluation.coco_eval, ait_tpu_torch.convert, "
            "ait_tpu_torch.utils, ait_tpu_torch.train.checkpoint, "
            "ait_tpu_torch.tools.trainval_net, ait_tpu_torch.tools.test_net, "
            "ait_tpu_torch.native, ait_tpu_torch.models.vgg, "
            "ait_tpu_torch.ops.roi_pool, "
            "ait_tpu_torch.tools.convert_torch_checkpoint; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'ait_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_native_route_loads_its_own_library():
    """The port's host C++ is its own build (csrc/ait_loader.cpp,
    csrc/ait_native.cpp into ait_tpu_torch/_build/), never the JAX
    package's native/libait_native.so."""
    code = ("from ait_tpu_torch import native; native.available(); "
            "maps = open('/proc/self/maps').read(); "
            "assert 'libait_native' not in maps; "
            "assert 'ait_tpu_torch/_build/ait_loader-' in maps, maps; "
            "assert 'ait_tpu_torch/_build/ait_native-' in maps, maps")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=300)


def test_train_step_without_device_raises_when_no_gpu(monkeypatch):
    from ait_tpu_torch.config import Config
    from ait_tpu_torch.models import AITDetector
    from ait_tpu_torch.train import (lr_schedule, make_optimizer,
                                     make_train_step)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config()
    model = AITDetector(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(model, make_optimizer(cfg, model),
                        lr_schedule(1e-3, 1, 1, 0.1))


def test_default_config_trains_on_cpu():
    """`Config()` unchanged (model.t_dropout 0.1, dec_prefix_per_image)
    trains: one step of one image on the CPU with finite losses, and every
    trainable leaf moved."""
    import numpy as np

    from ait_tpu_torch import bridge
    from ait_tpu_torch.config import Config
    from ait_tpu_torch.models import AITDetector
    from ait_tpu_torch.train import (lr_schedule, make_optimizer,
                                     make_train_step)

    cfg = Config()
    assert cfg.model.t_dropout > 0 and cfg.tpu.dec_prefix_per_image
    model = AITDetector(cfg)
    model.load_state_dict(bridge.to_state_dict(
        model, bridge.random_tree(bridge.jax_shapes(model), 0)))
    opt = make_optimizer(cfg, model)
    trainable = {id(p) for g in opt.param_groups for p in g["params"]}
    names = [k for k, p in model.named_parameters() if id(p) in trainable]
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    rng = np.random.RandomState(0)
    h, w = 160, 224
    gt = np.zeros((1, cfg.MAX_NUM_GT_BOXES, 5), np.float32)
    gt[0, 0] = [20, 30, 140, 120, 1]
    batch = {"image": rng.randint(0, 256, (1, h, w, 3)).astype(np.uint8),
             "query": rng.randint(0, 256, (1, 128, 128, 3)).astype(np.uint8),
             "im_info": np.asarray([[h, w, 1.0]], np.float32),
             "gt_boxes": gt}
    step = make_train_step(model, opt, lr_schedule(1e-3, 100, 5, 0.1),
                           device="cpu")
    met = step(batch, torch.Generator().manual_seed(0))
    assert all(np.isfinite(float(met[k])) for k in
               ("loss", "rpn_cls", "rpn_box", "rcnn_cls", "margin",
                "rcnn_box"))
    after = model.state_dict()
    assert names and not [k for k in names
                          if torch.equal(before[k], after[k])]


def test_gradient_accumulation_raises():
    """accum_steps > 1 runs the batch as equal microbatches: a batch it does
    not divide is refused before any forward (no model is touched)."""
    from ait_tpu_torch.train import grads_and_metrics

    with pytest.raises(ValueError, match="accum_steps"):
        grads_and_metrics(None, {"image": torch.zeros(3, 8, 8, 3)},
                          torch.Generator(), accum_steps=2)


def test_predictor_without_device_raises_when_no_gpu(monkeypatch):
    from ait_tpu_torch.config import Config
    from ait_tpu_torch.predict import OneShotPredictor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OneShotPredictor(Config(), {})


def test_chip_smoke_refuses_outside_a_checkout(tmp_path):
    """Alone in a directory, chip_smoke.py exits non-zero and prints no
    result line."""
    script = tmp_path / "chip_smoke.py"
    script.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_refuses_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
