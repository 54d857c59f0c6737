"""Finding a cell's files by name.

``BENCHMARK.json`` (at the root of the checkout) names the cells and the
metrics; ``workloads/<cell>.json`` holds a cell's configuration, traffic
generator and parameters, ``configs/<config>.json`` a configuration,
``traffic/<generator>.py``, ``systems/<system>.py``,
``reference/<config>.py`` and ``kinds/<kind>.py`` (a model's weights)
the code they name, and ``metrics/<metric>.py`` the reader of each
per-layer metric.  Adding a cell, a configuration, a model kind or a
metric adds files and entries; no file here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def benchmark(root=ROOT):
    return load_json(os.path.join(root, "BENCHMARK.json"))


def workload(name):
    return load_json(os.path.join(HERE, "workloads", name + ".json"))


def config(name):
    return load_json(os.path.join(HERE, "configs", name + ".json"))


def module(kind, name):
    """``perfbench.<kind>.<name>``: a traffic generator, a system, a
    reference or a model kind."""
    return importlib.import_module(f"perfbench.{kind}.{name}")


def metric_reader(name):
    """The ``read(ctx)`` of ``metrics/<name>.py`` (a metric's name may hold
    dots, so the file is loaded by its path)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench, cell, trace):
    """The metrics a run of ``cell`` reports: its end-to-end metrics
    (those without ``workloads``, and those that list it) with
    ``trace`` 0, else the per-layer metrics that list it, or that list no
    cells and move an end-to-end metric it reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def cell_entry(bench, cell):
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"no cell {cell!r} in BENCHMARK.json")
