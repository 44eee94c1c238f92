"""One run of one cell of the port's benchmark.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds BENCHMARK.json.  The cell's entry
there names its configuration (portbench/configs/), its traffic mix
(portbench/traffic/) and its chips; portbench/checks/<cell>.json holds the
limits of the correctness check, portbench/metrics/<name>.py the readers of
the per-layer metrics.  With --trace 0 the run measures the cell's
end-to-end metrics over a window of --seconds; with --trace 1 it profiles a
short window and prints the per-layer metrics.  Either way it then judges a
sample of what the window produced against the plain reference
(portbench/reference/) and prints, as the last line of its standard output,
one JSON object: correct, attempted, failed, metrics, device, the traced
breakdown, and last the compared numbers beside their limits.

The run needs as many CUDA devices as the cell asks for; without them it
exits 3 and prints no result.  It exits 4, with no result, if JAX or the
JAX package is loaded in this process once the window has closed.
"""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the program's own build caches live inside the checkout, at fixed paths
CACHE = os.path.join(ROOT, ".portbench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ait_tpu")


def _setup_paths():
    for p in (HERE, ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(CACHE, "torch_extensions"))
    os.environ["USE_FLAX"] = "0"


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def per_layer(cell, out):
    """The cell's per-layer metrics from the traced windows; a reader that
    finds nothing returns None and its metric is left out."""
    from benchlib.spec import reader
    from benchlib.tracefile import Trace

    traces = []
    for key in ("timeline_path", "trace_path"):
        path = out.pop(key)
        try:
            traces.append(Trace.from_file(path))
        finally:
            if os.path.exists(path):
                os.remove(path)
    timeline, tr = traces
    ctx = ReadCtx(cell, tr, out.pop("steps_traced"),
                  out.pop("flops_per_batch"), timeline.busy_s,
                  out.pop("window_s"), out.pop("plain_window_s"))
    metrics = {}
    for m in cell.per_layer:
        v = reader(m["name"], cell.root)(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    out["metrics"] = metrics
    out["device"].update(busy_s=ctx.busy_s, window_s=ctx.window_s)
    out["breakdown"] = {"device_ops": tr.top_device_ops(),
                        "idle_gaps": tr.idle_gaps()}


class ReadCtx:
    """What a per-layer reader reads, of windows of `steps` steps (batches
    or train steps) of `flops_per_step` operations each.  `plain_window_s`:
    the length by the host clock of such a window run unprofiled, as the
    untraced runs go.  `busy_s` and `window_s`: the device's busy seconds
    in the first profiled window, which records the device alone, and that
    window's length.  `trace` is the second profiled window, with the
    benchmark's ranges: device time by layer and by kernel call."""

    def __init__(self, cell, trace, steps, flops_per_step, busy_s,
                 window_s, plain_window_s):
        self.cell, self.trace = cell, trace
        self.steps, self.flops_per_step = steps, flops_per_step
        self.busy_s, self.window_s = busy_s, window_s
        self.plain_window_s = plain_window_s
        self.kind = cell.traffic["kind"]


def checks(cell, judged):
    """{number: {"value", "limit"}} and whether each is within its limit."""
    if judged is None:
        return {"judged_batches": {"value": 0, "limit": 1}}, False
    out, ok = {}, True
    for name, limit in cell.limits.items():
        v = judged.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok = ok and good
        out[name] = {"value": v, "limit": limit}
    return out, ok


def main(argv=None):
    args = parse(argv)
    _setup_paths()
    from benchlib import spec

    cell = spec.load_cell(args.workload)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has {have}", file=sys.stderr)
        return 3
    import importlib

    kind = importlib.import_module("benchlib." + cell.traffic["kind"])
    out = kind.run(cell, args.seed, args.seconds, bool(args.trace), T0)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 4
    if args.trace:
        per_layer(cell, out)
    gc.collect()
    compared, ok = checks(cell, out.pop("judged"))
    failed = out.pop("failed", 0)
    result = {"correct": bool(ok and failed == 0),
              "attempted": out["attempted"], "failed": failed,
              "metrics": out["metrics"],
              "device": dict(platform="gpu",
                             kind=torch.cuda.get_device_name(0),
                             count=cell.chips, **out["device"])}
    if "breakdown" in out:
        result["breakdown"] = out["breakdown"]
    result["checks"] = compared
    for name, c in compared.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
