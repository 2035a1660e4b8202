"""A cell's pieces, found by name: ``BENCHMARK.json`` at the checkout's
root names the cell's configuration, traffic and metrics; each lives in
a file of its own under ``perfbench/``:

    configs/<config>.json     the model, its exchange and optimizer
    traffic/<traffic>.json    workers, rows and lengths
    limits/<cell>.json        the limit of each number ``correct`` compares
    metrics/<metric>.py       a per-layer metric's reader: read(rec)

Adding a cell, a configuration, a mix or a metric is adding files and
entries: nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os

PERFBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PERFBENCH)


def manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(base: str, *parts) -> dict:
    with open(os.path.join(base, *parts)) as f:
        return json.load(f)


def config(name: str, base: str = PERFBENCH) -> dict:
    return _json(base, "configs", f"{name}.json")


def traffic(name: str, base: str = PERFBENCH) -> dict:
    return _json(base, "traffic", f"{name}.json")


def limits(cell_name: str, base: str = PERFBENCH) -> dict:
    return _json(base, "limits", f"{cell_name}.json")


def reader(metric: str, base: str = PERFBENCH):
    """The ``read(rec)`` function of ``metrics/<metric>.py``."""
    path = os.path.join(base, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, man: dict | None = None, base: str = PERFBENCH) -> dict:
    """Everything a run of cell ``name`` needs, resolved from its files
    (``base``: the benchmark's folder; ``man``: the manifest, by default
    the ``BENCHMARK.json`` beside that folder)."""
    man = man or manifest(os.path.dirname(base))
    found = [w for w in man["workloads"] if w["name"] == name]
    if len(found) != 1:
        raise KeyError(f"workload {name!r} is not in BENCHMARK.json")
    w = found[0]
    return {"name": name, "chips": int(w["chips"]),
            "conf": config(w["config"], base),
            "traffic": traffic(w["traffic"], base),
            "limits": limits(name, base),
            "end_to_end": [m for m in man["end_to_end"]
                           if _reports(m, name)],
            "per_layer": [m for m in man["per_layer"] if _reports(m, name)]}
