"""What the harness finds by name: the benchmark file, a cell's
configuration and traffic files, and the metric readers.

* ``BENCHMARK.json`` at the root of the checkout lists the cells
  (``workloads``), the configurations and the metrics;
* a configuration is the JSON file its entry names (under
  ``pgbench/configs/``), whose ``system`` names the module that builds it,
  ``pgbench/systems/<system>.py``;
* a traffic mix is ``pgbench/traffic/<traffic>.json``;
* a metric is ``pgbench/metrics/<name>.py`` with ``read(record)``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root=ROOT) -> dict:
    with open(pathlib.Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                   f"have {[w['name'] for w in bench['workloads']]}")


def config(bench: dict, name: str, root=ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(pathlib.Path(root) / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as f:
        return json.load(f)


def system(cfg: dict):
    return importlib.import_module(f"pgbench.systems.{cfg['system']}")


def metrics_for(bench: dict, cell_name: str, trace: bool) -> list:
    """The metric entries a cell reports: its end-to-end metrics, or with
    ``trace`` its per-layer metrics (those without ``workloads`` or
    listing the cell)."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]


def reader(name: str):
    """``read(record)`` of ``pgbench/metrics/<name>.py`` (a metric's name
    may hold dots, so it is loaded by path)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"pgbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
