"""A cell, found by name: its entry in ``BENCHMARK.json``, the
configuration file it names, ``traffic/<traffic>.json`` and one reader a
metric in ``metrics/<metric>.py``. Adding a cell, a configuration or a
metric adds files and entries; nothing here changes."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(workload: str, root: Path = ROOT) -> Cell:
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in manifest["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    config = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    return Cell(
        name=workload,
        chips=int(entry["chips"]),
        config=json.loads((root / config["file"]).read_text()),
        traffic=json.loads((root / "demux_bench" / "traffic" / f"{entry['traffic']}.json").read_text()),
        end_to_end=[m for m in manifest["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in manifest["per_layer"] if _applies(m, workload)],
    )


def reader(name: str, root: Path = ROOT):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    path = root / "demux_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"demux_bench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
