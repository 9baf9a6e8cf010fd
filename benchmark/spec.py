"""``BENCHMARK.json`` and the files it names, found by name.

Everything that belongs to one configuration, traffic mix, per-layer metric
or cell sits in files of its own, so a later change adds files and entries
and edits none:

* a configuration: the JSON file its entry's ``file`` names;
* a traffic mix: ``traffic/<mix>.json``, a data file of parameters that
  names its ``driver``;
* a driver, the one general generator and caller of a kind of traffic:
  ``drivers/<driver>.py``, whose ``Session`` makes the calls, gives their
  end-to-end readings and judges them (:mod:`benchmark.drivers.fit`);
* a per-layer metric: ``metrics/<metric>.py``, whose ``read(run)`` returns
  the number or None (:mod:`benchmark.run` says what ``run`` holds);
* a cell's limits of the comparison that decides ``correct``:
  ``limits/<cell>.json``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Optional

__all__ = ["ROOT", "BENCH_DIR", "NAME", "UNIT", "load", "workload",
           "config_for", "traffic_for", "driver_for", "limits_for",
           "metric_reader", "metrics_for"]

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
#: A name: a letter, digit or ``_`` first, then at most 63 more of letters,
#: digits, ``_``, ``.`` and ``-``.
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
#: A unit: 1 to 16 of letters, digits, ``_``, ``/``, ``%``, ``.`` and ``-``.
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_for(bench: dict, wl: dict, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == wl["config"]:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no config {wl['config']!r} in BENCHMARK.json")


def traffic_for(mix: str) -> dict:
    with open(BENCH_DIR / "traffic" / f"{mix}.json") as f:
        return json.load(f)


def driver_for(traffic: dict):
    """The module ``drivers/<traffic["driver"]>.py``."""
    name = traffic["driver"]
    if not name.isidentifier():
        raise ValueError(f"a driver's name is an identifier: {name!r}")
    return importlib.import_module(f"benchmark.drivers.{name}")


def limits_for(cell: str) -> Optional[dict]:
    path = BENCH_DIR / "limits" / f"{cell}.json"
    if not path.exists():
        return None
    with open(path) as f:
        return json.load(f)


def metric_reader(name: str) -> Callable:
    """``read`` of ``metrics/<name>.py``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_for(entries: list, cell: str) -> list:
    """The entries of ``end_to_end`` or ``per_layer`` that ``cell``
    reports: those with no ``workloads`` key and those that list it."""
    return [m for m in entries if cell in m.get("workloads", [cell])]
