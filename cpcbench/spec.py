"""Finding a cell's files by the names ``BENCHMARK.json`` gives."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Optional

#: The checkout's root: the directory that holds ``BENCHMARK.json``.
ROOT = Path(__file__).resolve().parents[1]
#: This package's directory, where the data files and readers live.
BENCH = "cpcbench"


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    chips: int
    config: dict          # configs/<config>.json
    mix: dict             # traffic/<mix>.json
    cell: dict            # cells/<workload>.json
    end_to_end: list      # the entries of the metrics this cell reports
    per_layer: list
    root: Path

    def reader(self, metric: str) -> Callable:
        """The ``read`` function of ``metrics/<metric>.py``."""
        return load_reader(metric, self.root)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def find_cell(workload: str, root: Optional[Path] = None) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` (default: this
    checkout's); raises ``KeyError`` for a name it does not list."""
    root = Path(root or ROOT)
    bench = _json(root / "BENCHMARK.json")
    entry = {w["name"]: w for w in bench["workloads"]}[workload]
    conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    base = root / BENCH
    return Cell(
        name=workload, chips=int(entry["chips"]),
        config=_json(root / conf["file"]),
        mix=_json(base / "traffic" / f"{entry['traffic']}.json"),
        cell=_json(base / "cells" / f"{workload}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
        root=root)


def load_reader(metric: str, root: Optional[Path] = None) -> Callable:
    """``read(run)`` of ``root/cpcbench/metrics/<metric>.py``: it returns the
    metric's value from a traced run, or ``None`` where it finds nothing
    to read."""
    path = Path(root or ROOT) / BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"cpcbench_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
