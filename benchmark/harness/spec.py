"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<name>`` is the ``workloads`` entry of that name; its configuration
is ``benchmark/configs/<config>.json`` (the entry's ``file``), its traffic
``benchmark/workloads/<name>.json`` (the driver module, the traffic's parameters and
the limits of ``correct``), its driver ``benchmark/drivers/<driver>.py`` and
each per-layer metric ``<metric>`` the reader ``benchmark/metrics/<metric>.py``.
Adding a cell, a configuration or a metric adds files and entries; no file
here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict           # the configuration file's contents
    workload: Dict         # benchmark/workloads/<name>.json
    end_to_end: List[str]  # the end-to-end metrics this cell reports
    per_layer: List[str]   # the per-layer metrics this cell reports
    units: Dict[str, str]  # every metric's unit


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    entry = {w["name"]: w for w in spec["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    conf = {c["name"]: c for c in spec["configs"]}[entry["config"]]
    return Cell(
        name=name, chips=int(entry["chips"]),
        config=json.loads((root / conf["file"]).read_text()),
        workload=json.loads((root / "benchmark" / "workloads" / f"{name}.json").read_text()),
        end_to_end=[m["name"] for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m["name"] for m in spec["per_layer"] if _reports(m, name)],
        units={m["name"]: m["unit"] for m in spec["end_to_end"] + spec["per_layer"]})


def load_module(path: Path) -> ModuleType:
    mod_spec = importlib.util.spec_from_file_location(f"benchmark_{path.stem}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


def driver(name: str, root: Path = ROOT) -> ModuleType:
    return load_module(root / "benchmark" / "drivers" / f"{name}.py")


def metric_reader(name: str, root: Path = ROOT) -> ModuleType:
    return load_module(root / "benchmark" / "metrics" / f"{name}.py")
