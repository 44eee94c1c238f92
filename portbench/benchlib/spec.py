"""What a run reads from the checkout, by name.

- `BENCHMARK.json` at the root: the cell (`workloads`), its metrics;
- `portbench/configs/<config>.json`: the configuration as it is run;
- `portbench/traffic/<traffic>.json`: the mix's parameters;
- `portbench/checks/<cell>.json`: each compared number's limit;
- `portbench/metrics/<metric>.py`: one reader a per-layer metric, a
  function `read(ctx)` that returns the number or None.

A cell, a configuration, a mix or a metric is added by adding files and
entries; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = "portbench"


def _load(path: str):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict            # the configuration file
    traffic: Dict           # the mix's parameters
    limits: Dict[str, float]
    end_to_end: List[Dict]  # the cell's end-to-end metric entries
    per_layer: List[Dict]   # the cell's per-layer metric entries
    root: str = ROOT        # the checkout that holds them

    @property
    def cfg(self) -> Dict:
        return self.config["config"]


def _applies(metric: Dict, cell: str, e2e_of_cell: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_of_cell


def load_cell(name: str, root: str = ROOT) -> Cell:
    bench = _load(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = _load(os.path.join(root, configs[w["config"]]["file"]))
    here = os.path.join(root, BENCH)
    traffic = _load(os.path.join(here, "traffic", w["traffic"] + ".json"))
    limits = _load(os.path.join(here, "checks", name + ".json"))
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, name, e2e_names)]
    return Cell(name, int(w["chips"]), conf, traffic, limits, e2e, per_layer,
                root)


def reader(metric: str, root: str = ROOT) -> Callable:
    """The `read` function of portbench/metrics/<metric>.py."""
    path = os.path.join(root, BENCH, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def program_config(cfg: Dict):
    """The program's Config: its defaults with every key of the
    configuration file's "config" set, refusing a key it lacks."""
    from ait_tpu_torch.config import Config

    def tup(v):
        return tuple(tup(x) for x in v) if isinstance(v, list) else v

    def apply(node, d, path):
        kw = {}
        names = {f.name for f in dataclasses.fields(node)}
        for k, v in d.items():
            if k not in names:
                raise ValueError(f"config key {path}{k} is not the program's")
            cur = getattr(node, k)
            kw[k] = (apply(cur, v, f"{path}{k}.")
                     if dataclasses.is_dataclass(cur) else tup(v))
        return dataclasses.replace(node, **kw)

    return apply(Config(), cfg, "")
