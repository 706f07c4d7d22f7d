"""Find a cell and everything that belongs to it by name.

`BENCHMARK.json` at the checkout's root lists the cells (`workloads`), each naming a
configuration and a traffic mix; the files are found from those names:

    benchmark/configs/<config>.json     sizes, source, `reduced`, `assumed`
    benchmark/traffic/<traffic>.json    the mix: which entry it drives and how
    benchmark/workloads/<cell>.json     the limits of the cell's correctness numbers
    benchmark/entries/<entry>.py        the adapter from the mix to the program
    benchmark/metrics/<metric>.py       one reader per metric, `read(run)`

so a new cell, configuration, mix or metric is a new file and a new list entry.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, here: str = HERE):
    """<here>/<kind>/<name>.py as a module (a name may hold dots)."""
    path = os.path.join(here, kind, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    """One cell: its BENCHMARK.json entry, configuration, traffic mix, limits and the
    metrics it reports (end to end, per layer), each metric its BENCHMARK.json entry."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    here: str = HERE

    @property
    def scene_path(self) -> str:
        return os.path.join(self.here, self.config["scene"])


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_path: str | None = None, here: str = HERE) -> Cell:
    """The cell `name` of the BENCHMARK.json at `bench_path` (the checkout's by
    default), its files found under `here` (this folder by default)."""
    bench = _json(bench_path or os.path.join(ROOT, "BENCHMARK.json"))
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    w = entries[0]
    config = _json(os.path.join(here, "configs", w["config"] + ".json"))
    traffic = _json(os.path.join(here, "traffic", w["traffic"] + ".json"))
    limits = _json(os.path.join(here, "workloads", name + ".json"))["limits"]
    return Cell(name, int(w["chips"]), config, traffic, limits,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)], here)
