"""Where the benchmark finds its pieces, by name.

- ``BENCHMARK.json`` at the root of the checkout: the cells (each with
  its configuration, traffic mix, chips and why), and the metrics each
  cell reports;
- ``configs/<config>.json``: a configuration (source, sizes, scan
  settings, the guarantees it states, what its plan must be);
- ``workloads/<cell>.json``: the mix's parameters that a cell overrides,
  under ``"params"``;
- ``traffic/<mix>.json``: a traffic mix's parameters (``generator.py``);
- ``metrics/<metric>.py``: a metric's reader.

Adding a configuration, cell, mix or metric is adding its file (and its
entry in ``BENCHMARK.json``); no other file changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _named(kind: str, name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    return name


def benchmark(root: Path = ROOT) -> dict:
    return _load_json(root / "BENCHMARK.json")


def config(name: str, here: Path = HERE) -> dict:
    return _load_json(here / "configs" / f"{_named('config', name)}.json")


def cell(name: str, here: Path = HERE, root: Path = ROOT) -> dict:
    """A cell: its entry in ``BENCHMARK.json`` (``config``, ``traffic``,
    ``chips``, ``why``), with its mix's parameters and the overrides of
    ``workloads/<cell>.json`` merged under ``"traffic_params"``."""
    entry = bench_cell(benchmark(root), _named("cell", name))
    if entry is None:
        raise ValueError(f"BENCHMARK.json has no cell {name!r}")
    c = dict(entry)
    own = _load_json(here / "workloads" / f"{name}.json")
    mix = _load_json(here / "traffic" / f"{_named('traffic', c['traffic'])}.json")
    from .generator import params

    c["traffic_params"] = params(mix, own.get("params", {}))
    return c


def cell_names(here: Path = HERE) -> List[str]:
    return sorted(p.stem for p in (here / "workloads").glob("*.json"))


def metric_module(name: str, here: Path = HERE) -> ModuleType:
    """The reader of metric ``name``: ``metrics/<name>.py``, loaded from
    its path (a name may hold dots)."""
    path = here / "metrics" / f"{_named('metric', name)}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, cell_name: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell_name`` reports: the end-to-end ones
    untraced, the per-layer ones traced; a metric with ``workloads``
    only in those cells."""
    out = []
    for m in bench["per_layer" if trace else "end_to_end"]:
        if "workloads" in m and cell_name not in m["workloads"]:
            continue
        out.append(m)
    return out


def bench_cell(bench: dict, name: str) -> Optional[dict]:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    return None


def spans_of(modules: Dict[str, ModuleType]) -> Dict[str, dict]:
    """Every span the metrics' readers declare: name -> ``{"targets":
    [...], "note": fn or None}``."""
    out: Dict[str, dict] = {}
    for mod in modules.values():
        for span, targets in getattr(mod, "SPANS", {}).items():
            notes = getattr(mod, "NOTES", {})
            out.setdefault(span, {"targets": [], "note": notes.get(span)})
            for t in targets:
                if t not in out[span]["targets"]:
                    out[span]["targets"].append(t)
    return out
