"""``BENCHMARK.json`` and the files its names lead to.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The harness finds, by those names alone:

* ``configs/<config>.json``: the configuration as it is run (its sizes,
  optimizer, leaves and how each is made, its reference's name);
* ``traffic/<traffic>.json``: the mix's parameters, among them ``loop``,
  the loop in ``loops/<loop>.py`` that runs it;
* ``limits/<workload>.json``: the limits of the numbers ``correct`` is
  decided by;
* ``metrics/<metric>.py``: one reader per per-layer metric.

A cell defined but held out of ``BENCHMARK.json`` (see ``PERF.md``) keeps
its entry in ``held/<workload>.json`` and its own metrics' entries in
``held/metrics.json``, in ``BENCHMARK.json``'s form: it runs as any other
cell, and moving the entries back is all that adding it takes.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Tuple

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def _json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> Dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def file_of(kind: str, name: str, ext: str = ".json",
            root: str = ROOT) -> str:
    """``<kind>/<name><ext>`` in the benchmark's folder under ``root``."""
    return os.path.join(root, os.path.basename(HERE), kind, name + ext)


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict
    traffic: Dict
    mix: str                            # the traffic mix's name
    chips: int
    limits: Dict[str, float]
    end_to_end: List[Tuple[str, str]]   # (name, unit)
    per_layer: List[Tuple[str, str]]


def held() -> List[Dict]:
    """The entries of the cells held out of ``BENCHMARK.json``."""
    folder = os.path.join(HERE, "held")
    return [_json(os.path.join(folder, f)) for f in sorted(os.listdir(folder))
            if f.endswith(".json") and f != "metrics.json"]


def _applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: str = ROOT) -> Cell:
    spec = benchmark(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload in cells:
        w = cells[workload]
    elif os.path.exists(file_of("held", workload, root=root)):
        w = _json(file_of("held", workload, root=root))
        held = _json(file_of("held", "metrics", root=root))
        spec["end_to_end"] += held["end_to_end"]
        spec["per_layer"] += held["per_layer"]
    else:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"({', '.join(sorted(cells))}) nor held")
    configs = {c["name"]: c for c in spec["configs"]}
    config = _json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _json(file_of("traffic", w["traffic"], root=root))
    limits = _json(file_of("limits", workload, root=root))
    return Cell(
        name=workload, config=config, traffic=traffic, mix=w["traffic"],
        chips=w["chips"], limits=limits,
        end_to_end=[(m["name"], m["unit"]) for m in spec["end_to_end"]
                    if _applies(m, workload)],
        per_layer=[(m["name"], m["unit"]) for m in spec["per_layer"]
                   if _applies(m, workload)])
