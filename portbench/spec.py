"""The benchmark as data: BENCHMARK.json at the checkout's root names the
cells and metrics; each configuration, traffic mix, cell's limits and
per-layer metric is a file of its own under portbench/, found by its name:

  configs/<config>.json     the configuration as it is run
  traffic/<traffic>.json    the traffic mix's parameters
  limits/<cell>.json        the limit of each number the cell compares
  metrics/<metric>.py       a reader: read(run) -> value or None

A later change adds a cell, a configuration, a traffic mix or a metric by
adding files and entries, never by editing one."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(kind: str, name: str, base: str = HERE) -> dict:
    path = os.path.join(base, kind, f"{name}.json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} file {path}")
    with open(path) as f:
        return json.load(f)


def config(name: str, base: str = HERE) -> dict:
    return _json("configs", name, base)


def traffic(name: str, base: str = HERE) -> dict:
    return _json("traffic", name, base)


def limits(cell: str, base: str = HERE) -> dict:
    return _json("limits", cell, base)


def metric_reader(name: str, base: str = HERE):
    """The read(run) function of metrics/<name>.py."""
    path = os.path.join(base, "metrics", f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no metric reader {path}")
    mod_name = "portbench_metric_" + name.replace(".", "_").replace("-", "_")
    sp = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_for(bench: dict, cell_name: str, trace: bool):
    """The metrics a run of the cell reports: the end-to-end ones, or with
    trace the per-layer ones, each that lists the cell or lists none."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if cell_name in m.get("workloads", [cell_name])]
