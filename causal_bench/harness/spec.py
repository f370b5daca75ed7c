"""Find everything of a cell by name.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic mix and lists the metrics.  The files behind
those names are found by convention, so a later change adds a cell, a
configuration, a mix or a metric by adding files and entries, never by
editing one:

* a configuration: the ``file`` its entry names (a JSON object whose
  ``driver`` names ``causal_bench/drivers/<driver>.py`` and whose
  ``overlay`` names ``causal_bench/gen/overlays/<overlay>.py``);
* a traffic mix: ``causal_bench/traffic/<traffic>.json``, whose
  ``arrivals`` names ``causal_bench/gen/arrivals/<arrivals>.py``;
* a metric: ``causal_bench/metrics/<name>.py``, whose ``read(ctx)``
  returns the number or None;
* a roofline: ``causal_bench/roofline/<kernel>.py``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import List

__all__ = ["BENCH_DIR", "ROOT", "CellSpec", "load_cell", "load_file",
           "load_metric", "load_roofline", "load_driver"]

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class CellSpec:
    """A cell with its configuration, mix and the metrics it reports."""

    name: str
    cell: dict            # the BENCHMARK.json workloads entry
    config: dict          # the configuration file's object
    traffic: dict         # the traffic file's object
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_file: Path = ROOT / "BENCHMARK.json"
              ) -> CellSpec:
    bench = json.loads(Path(bench_file).read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((ROOT / entry["file"]).read_text())
    traffic = json.loads(
        (BENCH_DIR / "traffic" / f"{cell['traffic']}.json").read_text())
    return CellSpec(
        name=name, cell=cell, config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def load_file(kind: str, name: str) -> ModuleType:
    """The module ``causal_bench/<kind>/<name>.py`` (``kind`` a directory
    such as ``metrics`` or ``gen/arrivals``; ``name`` may hold dots)."""
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no file {path} for {name!r}")
    spec = importlib.util.spec_from_file_location(
        f"causal_bench.{kind.replace('/', '.')}.{name.replace('.', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(name: str) -> ModuleType:
    return load_file("metrics", name)


def load_roofline(kernel: str) -> ModuleType:
    return load_file("roofline", kernel)


def load_driver(spec: CellSpec) -> ModuleType:
    return importlib.import_module(
        f"causal_bench.drivers.{spec.config['driver']}")
