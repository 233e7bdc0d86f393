"""What a run reads, found by name: `BENCHMARK.json` at the checkout's root,
and under this directory `configs/<config>.json`, `traffic/<mix>.json`,
`limits/<cell>.json`, `metrics/<metric>.py` (every metric, end to end or
per layer) and `kinds/<kind>.py` (what a run of a traffic mix's kind
does). A cell, a configuration, a traffic mix, a metric or a kind of run
is added by adding its files and its entry, without editing any file
that is there."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict          # configs/<config>.json, the configuration as run
    traffic: Dict         # traffic/<mix>.json
    limits: Dict          # limits/<cell>.json: number -> limit
    end_to_end: List[Dict]
    per_layer: List[Dict]


def applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT, here: Path = HERE) -> Cell:
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                       f"{sorted(cells)}")
    w = cells[name]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_json(here / "configs" / f"{w['config']}.json"),
        traffic=_json(here / "traffic" / f"{w['traffic']}.json"),
        limits=_json(here / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)])


def _module(kind: str, name: str, here: Path):
    path = here / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"port_bench_{kind}_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, here: Path = HERE):
    """The module `metrics/<name>.py`: its `read(ctx)` returns the metric's
    value from a run's `harness.Context`, or None where the run holds
    nothing to read it from."""
    return _module("metrics", name, here)


def kind_runner(kind: str, here: Path = HERE):
    """`run(cell, seed, seconds, trace, device, log=print, **fault)` of
    `kinds/<kind>.py`: one run of a cell whose traffic is of that kind,
    returning `attempted`, `failed`, `numbers` (what `check.judge` reads)
    and `ctx` (a `harness.Context`)."""
    return _module("kinds", kind, here).run
