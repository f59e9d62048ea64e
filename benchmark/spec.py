"""Finds the pieces of a cell by the names ``BENCHMARK.json`` gives them:
``configs/<config>.json``, ``traffic/<traffic>.json``, the traffic's loop
``loops/<loop>.py`` and, for each metric, its reader
``metrics/<metric>.py`` (a function ``read(run)``)."""

from __future__ import annotations

import importlib
import importlib.util
import json
from functools import lru_cache
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def loop(name: str):
    return importlib.import_module(f"benchmark.loops.{name}")


def metrics_for(bench: dict, cell: str, trace: bool) -> list:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones:
    those that list it under "workloads", or list no workloads."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


@lru_cache(maxsize=None)
def reader(metric: str):
    path = HERE / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{metric}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read
