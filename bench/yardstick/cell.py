"""A cell of ``BENCHMARK.json`` and the files that belong to it, found by
name: its configuration's file, ``traffic/<traffic>.json``,
``limits/<workload>.json``, and one reader for each metric that the cell
reports: ``end_to_end/<metric>.py`` (but ``setup_s``) and
``layer_metrics/<metric>.py``; a per-layer metric names its cells under
``workloads``.  A later change adds a cell, a configuration, a mix or a
metric as new files and entries, and edits none of these."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SETUP = "setup_s"    # taken by the harness itself, from process start


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, Callable] = field(default_factory=dict)


def reader(name: str, folder: str, bench: Path = BENCH) -> Callable:
    """``read(record)`` of ``<folder>/<name>.py``."""
    path = bench / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"{folder}_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def find(workload: str, root: Path = ROOT) -> Cell:
    """The cell named ``workload`` with its files; raises ``KeyError`` for
    a name ``BENCHMARK.json`` does not list."""
    b = benchmark(root)
    cells = {w["name"]: w for w in b["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; known: "
                       f"{sorted(cells)}")
    w = cells[workload]
    bench = root / "bench"
    configs = {c["name"]: c for c in b["configs"]}
    e2e = [m for m in b["end_to_end"]
           if workload in m.get("workloads", [workload])]
    per_layer = [m for m in b["per_layer"] if workload in m["workloads"]]
    return Cell(
        name=workload, chips=w["chips"],
        config=load_json(root / configs[w["config"]]["file"]),
        traffic=load_json(bench / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(bench / "limits" / f"{workload}.json"),
        end_to_end=e2e, per_layer=per_layer,
        readers={**{m["name"]: reader(m["name"], "end_to_end", bench)
                    for m in e2e if m["name"] != SETUP},
                 **{m["name"]: reader(m["name"], "layer_metrics", bench)
                    for m in per_layer}})
