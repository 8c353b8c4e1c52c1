"""Finds the benchmark's parts by name, so that a configuration, a cell, a
traffic mix or kind, a graph kind, a per-layer metric or a hand kernel is
added by adding a file:

- ``configs/<config>.json``: the model's widths, graph and precision;
- ``workloads/<cell>.json``: the cell's configuration, traffic, chips,
  why, and the limits of its correctness comparison;
- ``traffic/<traffic>.json``: a traffic mix (its ``kind`` and parameters),
  driven by ``traffic/<kind>.py``;
- ``graphs/<kind>.py``: how a configuration's graph is made, for the
  program and for the reference;
- ``metrics/<metric>.py``: the reader of one per-layer metric;
- ``kernels/<kernel>.json``: a hand kernel's device-name pattern.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _json(folder: str, name: str, root: Path | None = None) -> dict:
    path = (root or ROOT) / folder / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no {folder[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def _module(folder: str, name: str, root: Path | None = None):
    path = (root or ROOT) / folder / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {folder} module named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"gwbench_{folder}_{name}".replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def config(name: str, root: Path | None = None) -> dict:
    return _json("configs", name, root)


def workload(name: str, root: Path | None = None) -> dict:
    return _json("workloads", name, root)


def traffic(name: str, root: Path | None = None) -> dict:
    return _json("traffic", name, root)


def traffic_kind(kind: str, root: Path | None = None):
    return _module("traffic", kind, root)


def graph_kind(kind: str, root: Path | None = None):
    return _module("graphs", kind, root)


def kernels(root: Path | None = None) -> list[dict]:
    """Every hand kernel, in name order."""
    out = []
    for path in sorted(((root or ROOT) / "kernels").glob("*.json")):
        with open(path) as f:
            out.append(json.load(f) | {"name": path.stem})
    return out


def metric_readers(root: Path | None = None) -> dict:
    """``{metric name: module}`` for every file in ``metrics/``; a module
    has ``UNIT`` and ``read(records) -> float | None``."""
    return {path.stem: _module("metrics", path.stem, root)
            for path in sorted(((root or ROOT) / "metrics").glob("*.py"))}


def cell(name: str, root: Path | None = None) -> dict:
    """A cell with its configuration and traffic mix resolved."""
    w = workload(name, root)
    return {"name": name, "workload": w,
            "config": config(w["config"], root),
            "traffic": traffic(w["traffic"], root)}
