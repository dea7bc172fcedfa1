"""Everything a run finds by name from ``BENCHMARK.json``.

A cell names a configuration and a traffic mix; a configuration names its
file; the traffic mix is ``portbench/traffic/<traffic>.json``; each per-layer
metric is read by ``portbench/metrics/<name>.py``; the limits of the check
that decides ``correct`` are ``portbench/limits/<config>.json``.  Adding a
cell, a mix, a metric or a configuration adds files and entries and edits
none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

__all__ = ["ROOT", "Cell", "load_manifest", "load_cell", "metric_reader"]

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_manifest(root: str = ROOT) -> Dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` with its configuration, traffic mix, limits and the
    metrics it reports.  Raises KeyError for a cell the manifest lacks."""
    man = load_manifest(root)
    wl = {w["name"]: w for w in man["workloads"]}[name]
    cfg_entry = {c["name"]: c for c in man["configs"]}[wl["config"]]
    config = _json(os.path.join(root, cfg_entry["file"]))
    traffic = _json(os.path.join(root, "portbench", "traffic", wl["traffic"] + ".json"))
    limits = _json(os.path.join(root, "portbench", "limits", wl["config"] + ".json"))
    return Cell(name=name, chips=int(wl["chips"]), config=config, traffic=traffic,
                limits=limits,
                end_to_end=[m for m in man["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in man["per_layer"] if _applies(m, name)])


def metric_reader(name: str, root: str = ROOT) -> Callable[[Dict], Optional[float]]:
    """``read(record)`` of ``portbench/metrics/<name>.py`` (loaded by path, so
    a name may hold dots)."""
    path = os.path.join(root, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
