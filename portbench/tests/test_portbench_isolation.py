"""What the benchmark may import.  Nothing that portbench/run.py can reach
is JAX, flax, optax or the JAX package `ait_tpu` (top-level names compared
whole: the port `ait_tpu_torch` begins with the JAX package's name and is
allowed), and the reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "ait_tpu"}


def _sources(sub=""):
    base = os.path.join(BENCH, sub)
    for d, dirs, files in os.walk(base):
        dirs[:] = [x for x in dirs if x not in ("tests", "__pycache__")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _top_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value.split(".", 1)[0]


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = set(_top_imports(path)) & FORBIDDEN
        assert not bad, f"{path} imports {bad}"


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        tops = set(_top_imports(path))
        assert "ait_tpu_torch" not in tops, path
        assert "benchlib" not in tops, path


def test_loaded_modules_hold_no_jax():
    """Import everything a run imports, the program's entry points too, in
    a fresh interpreter, and list the top-level names it loaded."""
    code = r"""
import importlib, os, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import run
run._setup_paths()
from benchlib import counts, judge, probes, serve, spec, tracefile, train
from benchlib import traffic, weights, rooflines
from reference import boxes, model, params, philox
from reference import train as rtrain
importlib.import_module("ait_tpu_torch.predict")
importlib.import_module("ait_tpu_torch.train")
importlib.import_module("ait_tpu_torch.train.optim")
importlib.import_module("ait_tpu_torch.models")
for f in os.listdir(os.path.join(sys.argv[1], "metrics")):
    spec.reader(f[:-3])
print(",".join(run.forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code, BENCH, ROOT],
                         capture_output=True, text=True, check=True,
                         cwd=ROOT, env={**os.environ, "PYTHONPATH": ""})
    assert out.stdout.strip().splitlines()[-1:] in ([], [""]), out.stdout


def test_forbidden_modules_compares_whole_names():
    sys.path[:0] = [BENCH]
    import run

    saved = dict(sys.modules)
    try:
        sys.modules["ait_tpu_torch_fake"] = sys
        sys.modules.pop("ait_tpu", None)
        assert "ait_tpu" not in run.forbidden_modules()
        sys.modules["ait_tpu.sub"] = sys
        assert "ait_tpu" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
