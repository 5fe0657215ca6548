"""Timing and record plumbing shared by the measurement tools.

Device time is taken by ``torch.cuda.Event(enable_timing=True)`` around
whole public calls, each ending in its host fetch and expansion, then
``torch.cuda.synchronize()``; on the CPU (``--device cpu``) the same
calls are timed by ``time.perf_counter``.  Host work (build, plan, pack)
is timed by ``time.perf_counter`` everywhere.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .. import soak
from ..ops._build import launch_counts

#: the PHP extension's implied scan rate: 2 MiB a pass in 0.174326 s,
#: automaton build included (its README; ``bench.py``)
REFERENCE_GBPS = 2.0 * 1024**2 / 0.174326 / 1e9


def parser(description: str) -> argparse.ArgumentParser:
    """The flags every tool takes: ``--device`` and ``--artifact``."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: the current CUDA card; raises with "
             "none); 'cpu' runs the kernels' plain versions")
    ap.add_argument(
        "--artifact", metavar="PATH", default=None,
        help="also write the record to PATH (the only file a tool writes)")
    return ap


def card_line(device: torch.device) -> str:
    """The device a record was measured on: the card's name and its power
    limit (``nvidia-smi``), as ``"NVIDIA H100 80GB HBM3, 700.00 W"``;
    ``"cpu"`` on the CPU."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
         f"--id={device.index or 0}"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return (f"{torch.cuda.get_device_name(device)}, "
            f"{out.stdout.strip().splitlines()[0]}")


def hash_seed() -> str:
    """The ``PYTHONHASHSEED`` this process runs under: the reference
    tools build needle lists from sets, so their order (the pattern ids)
    follows it."""
    return os.environ.get("PYTHONHASHSEED", "random")


def timestamp() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


def call_ms(device: torch.device, fn: Callable) -> Tuple[float, object]:
    """``(ms, fn())`` of one call: CUDA events around it and a
    synchronize after it on a card, the host clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return (time.perf_counter() - t0) * 1e3, out
    torch.cuda.synchronize(device)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize(device)
    return e0.elapsed_time(e1), out


def runs_ms(device: torch.device, fn: Callable, runs: int,
            per: int = 1) -> List[float]:
    """Ms a unit of ``runs`` calls of ``fn`` (each doing ``per`` units),
    ascending."""
    return sorted(call_ms(device, fn)[0] / per for _ in range(runs))


class Kernels:
    """Which hand kernels a tool launched on ``device``: the counters from
    the tool's start, and on a card the largest difference from the plain
    version over one held pass (:func:`soak.held_to_plain`); on the CPU
    the wrappers are the plain versions, and the difference is None."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.start = launch_counts()
        self.err: Optional[Dict[str, int]] = None

    def hold(self, fn: Callable) -> None:
        """On a card, run ``fn`` once with every launch held to the plain
        version on the same inputs (before anything is timed: it also
        warms the workload)."""
        if self.device.type != "cuda":
            return
        with soak.held_to_plain() as err:
            fn()
        self.err = dict(err)

    def record(self) -> Dict[str, dict]:
        if self.device.type == "cuda" and self.err is None:
            raise RuntimeError("no held pass ran on the card")
        return {name: {
            "launches": n,
            "max_abs_err": None if self.err is None else self.err[name],
        } for name, n in launch_counts(self.start).items()}


def finish(record: dict, artifact: Optional[str]) -> dict:
    """Write ``record`` to ``artifact`` (when given) and print it as the
    last line."""
    line = json.dumps(record)
    if artifact:
        d = os.path.dirname(os.path.abspath(artifact))
        os.makedirs(d, exist_ok=True)
        with open(artifact, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return record

