"""Find a cell's pieces by name.

``BENCHMARK.json`` at the root names the cells, configurations and metrics.
Everything that belongs to one of them sits in a file of its own under the
benchmark's folder, found by its name:

* ``configs/<config>.json``: the model as it is run and its serving shape
  (the path is the configuration's ``file`` entry);
* ``traffic/<mix>.json``: the traffic mix's parameters and its rate;
* ``metrics/<metric>.py``: the reader of one per-layer metric, a function
  ``read(ctx)`` that returns a number or None;
* ``work/<kernel>.py``: the frozen operation and byte counts of a kernel.

A later change adds a cell, a configuration, a mix or a metric by adding
files and entries, and edits no code.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    bench_dir: Path


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no BENCHMARK.json under {root}")
    with open(path) as f:
        return json.load(f)


def bench_dir(bench: Dict[str, Any], root: Path = ROOT) -> Path:
    """The benchmark's own folder: the first of ``paths``."""
    return Path(root) / bench["paths"][0]


def applies(metric: Dict[str, Any], workload: str) -> bool:
    """A metric without a ``workloads`` key is read in every cell."""
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r}; have {sorted(by_name)}")
    w = by_name[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[w["config"]]
    with open(Path(root) / entry["file"]) as f:
        config = json.load(f)
    config["name"] = entry["name"]
    folder = bench_dir(bench, root)
    with open(folder / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    traffic["name"] = w["traffic"]
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if applies(m, workload)],
                per_layer=[m for m in bench["per_layer"]
                           if applies(m, workload)],
                bench_dir=folder)


def load_module(path: Path, name: str):
    """Import one file by path (metric names hold dots, so they are not
    importable as module names)."""
    spec = importlib.util.spec_from_file_location(
        f"servebench_dyn.{name.replace('.', '_')}", path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(folder: Path, metric: str) -> Callable[[Any], Optional[float]]:
    """``read(ctx)`` of ``metrics/<metric>.py``."""
    path = Path(folder) / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {metric!r}: {path}")
    return load_module(path, f"metric.{metric}").read


def work_module(folder: Path, kernel: str):
    """The frozen counts of ``work/<kernel>.py``."""
    return load_module(Path(folder) / "work" / f"{kernel}.py",
                       f"work.{kernel}")
