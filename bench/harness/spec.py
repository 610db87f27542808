"""Everything of a cell is found by its name, with no list in code.

* ``BENCHMARK.json`` at the root of the checkout: the end-to-end and
  per-layer metrics and which cells report them;
* ``bench/workloads/<cell>.json``: the cell's configuration, driver
  (``entry``), traffic parameters, chips and why;
* ``bench/configs/<config>.json``: the configuration's sizes, source,
  ``reduced`` and ``assumed``;
* ``bench/drivers/<entry>.py``: the driver of one kind of entry;
* ``bench/metrics/<metric>.py``: one reader per per-layer metric.

A later change adds a cell, a configuration or a metric as new files and
new entries of ``BENCHMARK.json``; nothing here lists them.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict:
    return _read_json(root / "BENCHMARK.json")


def cell_names(bench: Path = BENCH) -> List[str]:
    return sorted(p.stem for p in (bench / "workloads").glob("*.json"))


def load_cell(name: str, bench: Path = BENCH) -> Dict:
    path = bench / "workloads" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no cell {name!r}: {path} is missing "
                                f"(cells: {', '.join(cell_names(bench))})")
    return _read_json(path)


def load_config(name: str, bench: Path = BENCH) -> Dict:
    return _read_json(bench / "configs" / f"{name}.json")


def load_module(path: Path, name: str):
    """Import a file by its path (metric files carry dots in their
    names, so they are no importable module names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(entry: str, bench: Path = BENCH):
    return load_module(bench / "drivers" / f"{entry}.py",
                       f"bench_driver_{entry}")


def load_metric(name: str, bench: Path = BENCH):
    return load_module(bench / "metrics" / f"{name}.py",
                       "bench_metric_" + name.replace(".", "_")
                       .replace("-", "_"))


def _reports(metric: Dict, cell: str, e2e_of_cell: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    return moves is None or moves in e2e_of_cell


def cell_metrics(cell: str, bench_json: Dict) -> Dict[str, List[Dict]]:
    """{"end_to_end": [...], "per_layer": [...]}: the metric entries of
    ``BENCHMARK.json`` that ``cell`` reports."""
    e2e = [m for m in bench_json["end_to_end"] if _reports(m, cell, [])]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in bench_json["per_layer"]
                 if _reports(m, cell, names)]
    return {"end_to_end": e2e, "per_layer": per_layer}
