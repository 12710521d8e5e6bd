"""Finding the benchmark's parts by name.

BENCHMARK.json (at the checkout's root) names every cell and metric; each
has a file here: configs/<config>.json, traffic/<traffic>.json,
workloads/<cell>.json, metrics/<metric>.py and reference/<check>.py.  A new
cell, configuration or metric is new files and new entries, never an edit.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def benchmark(root: str = ROOT) -> dict:
    return _json(root, "BENCHMARK.json")


def cell(name: str, root: str = ROOT) -> dict:
    """The cell's BENCHMARK.json entry merged with workloads/<name>.json,
    its configuration and its traffic, and the metrics it reports."""
    spec = benchmark(root)
    here = os.path.join(root, "benchmark")
    entries = [w for w in spec["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    work = _json(here, "workloads", f"{name}.json")
    for key in ("config", "traffic"):
        if work[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json names {key} {work[key]!r}, "
                             f"BENCHMARK.json {entry[key]!r}")
    return {
        **entry,
        "workload": work,
        "config_data": _json(here, "configs", f"{entry['config']}.json"),
        "traffic_data": _json(here, "traffic", f"{entry['traffic']}.json"),
        "end_to_end": metrics_of(spec, "end_to_end", name),
        "per_layer": metrics_of(spec, "per_layer", name),
    }


def metrics_of(spec: dict, kind: str, cell_name: str) -> List[dict]:
    """The metrics of `kind` that `cell_name` reports: those that list it,
    and those without a list (a per-layer metric without one goes with its
    end-to-end metric's cells)."""
    e2e_here = {m["name"] for m in metrics_of(spec, "end_to_end", cell_name)} \
        if kind == "per_layer" else set()
    out = []
    for m in spec[kind]:
        if "workloads" in m:
            if cell_name in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e_here:
            out.append(m)
    return out


def metric_reader(name: str, root: str = ROOT):
    """The module of metrics/<name>.py under `root`."""
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    loader = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    module = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(module)
    return module


def check_module(name: str):
    return importlib.import_module(f"benchmark.reference.{name}")


def names(kind: str, root: str = ROOT) -> Dict[str, str]:
    """Every file of a kind under `root`, by name: configs, traffic,
    workloads (.json) or metrics (.py)."""
    folder = os.path.join(root, "benchmark", kind)
    ext = ".py" if kind == "metrics" else ".json"
    return {f[:-len(ext)]: os.path.join(folder, f) for f in sorted(os.listdir(folder))
            if f.endswith(ext) and not f.startswith("_")}
