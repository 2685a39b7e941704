"""Finding a cell's parts by name: ``workloads/<cell>.json`` names its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<mix>.json``), its entry (``entries/<entry>.py``) and the
entry's parameters; ``metrics/<metric>.py`` reads one per-layer metric;
``BENCHMARK.json`` at the root of the checkout says which metrics a cell
reports.  A cell, configuration, mix, entry or metric is added by adding
its file."""

from __future__ import annotations

import importlib
import json
import os
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(*parts: str) -> Dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_cell(name: str) -> Dict:
    """The cell file with its configuration and mix read in: keys
    ``name``, ``config`` (name), ``traffic`` (name), ``entry``,
    ``params``, ``limits``, ``configuration`` and ``mix`` (their files'
    contents)."""
    cell = _json("workloads", name + ".json")
    cell["name"] = name
    cell["configuration"] = _json("configs", cell["config"] + ".json")
    cell["mix"] = _json("traffic", cell["traffic"] + ".json")
    return cell


def entry(name: str):
    return importlib.import_module(f"segbench.entries.{name}")


def metric_reader(name: str):
    """The module whose ``read(ctx)`` gives the per-layer metric ``name``
    (None where the run has nothing to read it from)."""
    return importlib.import_module(f"segbench.metrics.{name}")


def benchmark() -> Dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"BENCHMARK.json has no workload {name!r}")


def metrics_of(bench: Dict, name: str, kind: str) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that cell ``name``
    reports: those without a ``workloads`` list, and those whose list
    names it."""
    return [m for m in bench[kind]
            if "workloads" not in m or name in m["workloads"]]
