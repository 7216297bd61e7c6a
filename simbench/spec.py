"""The benchmark's description, read from ``BENCHMARK.json`` and the files
it names: a cell is a configuration (``simbench/configs/<name>.json``)
under a traffic mix (``simbench/traffic/<name>.json``), and a per-layer
metric is read by ``simbench/metrics/<name>.py``. Nothing here names a
cell: a new cell, mix or metric is new files and entries only.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


class SpecError(RuntimeError):
    """The checkout lacks a file the cell needs, or a file is malformed."""


def _json(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError as e:
        raise SpecError(f"missing {path.relative_to(ROOT)}") from e
    except json.JSONDecodeError as e:
        raise SpecError(f"{path.relative_to(ROOT)}: {e}") from e


def load_module(path: Path, name: str):
    """Import one of the benchmark's files by its path."""
    if not path.is_file():
        raise SpecError(f"missing {path.relative_to(ROOT)}")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    reader: object  # a module with read(ctx) -> float | None, or None


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # simbench/configs/<config>.json
    traffic: dict  # simbench/traffic/<traffic>.json
    end_to_end: list[Metric]
    per_layer: list[Metric]


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, bench: Path | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files; the per-layer
    readers of the metrics that the cell reports."""
    spec = _json(bench or ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec.get("workloads", [])}
    if name not in cells:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json; "
                        f"there are {sorted(cells)}")
    w = cells[name]
    config = _json(HERE / "configs" / f"{w['config']}.json")
    traffic = _json(HERE / "traffic" / f"{w['traffic']}.json")
    e2e = [Metric(m["name"], m["unit"], None)
           for m in spec["end_to_end"] if _applies(m, name)]
    layer = [Metric(m["name"], m["unit"],
                    load_module(HERE / "metrics" / f"{m['name']}.py",
                                f"simbench_metric_{m['name']}"))
             for m in spec["per_layer"] if _applies(m, name)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, layer)
