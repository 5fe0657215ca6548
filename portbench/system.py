"""The system under test, driven through its public ``Matcher`` API.

:class:`Program` is ``php_aho_corasick_tpu_torch``.  The mix's
``matcher`` says how the matcher comes to be (built in set-up, built in
every call, or loaded from a saved file), ``units`` whether the documents
are uploaded into resident handles (``device_corpus``) or kept on the
host as fresh batches, and ``call`` which public entry a call drives
(:data:`ENTRIES`).  A call returns its records in host memory, one record
dict a unit.  :class:`Control` puts the plain reference, with one
guarantee broken, in the program's place.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .generator import call_units

ROOT = Path(__file__).resolve().parent.parent
#: where a ``"saved"`` matcher's file is kept, inside the checkout
SAVED = ROOT / "build" / "portbench" / "matchers"


def devices_of(chips: int, device: str) -> List[torch.device]:
    """The devices a run of ``chips`` cards uses, the first holding the
    matcher."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return [dev]
    return [torch.device("cuda", i) for i in range(chips)]


def _many(m, units: list) -> List[dict]:
    return m.match_arrays_many(units)


def _one(m, units: list) -> List[dict]:
    (unit,) = units
    return [m.match_arrays(unit)]


def _stream(m, units: list, batch: int) -> List[dict]:
    out: List[dict] = []
    for res in m.match_arrays_stream(
            [units[a : a + batch] for a in range(0, len(units), batch)]):
        out.extend(res)
    return out


#: a mix's ``call`` -> what the call does with the matcher and its units
ENTRIES = {"match_arrays_many": _many, "match_arrays": _one,
           "match_arrays_stream": _stream}


class Program:
    """One matcher and its inputs, as a user of the port would hold them."""

    def __init__(self, config: dict, traffic: dict, chips: int,
                 device: str = "cuda") -> None:
        self.config = config
        self.traffic = traffic
        self.chips = chips
        self.devices = devices_of(chips, device)
        self.stack = contextlib.ExitStack()
        from php_aho_corasick_tpu_torch.parallel.mesh import local_shards

        if chips == 1:
            # one card, even where the host has more
            self.stack.enter_context(local_shards(1))
        elif self.devices[0].type == "cpu":
            # a CPU rehearsal of the mesh: ``chips`` shards of the CPU
            self.stack.enter_context(local_shards(chips))
        self.m = None
        self.specs: List[dict] = []
        self.units: list = []
        self.timings: Dict[str, float] = {}
        entry = ENTRIES[traffic["call"]]
        if traffic["call"] == "match_arrays_stream":
            batch = traffic["stream_batch"]
            self.entry = lambda m, units: entry(m, units, batch)
        else:
            self.entry = entry

    def _new_matcher(self):
        from php_aho_corasick_tpu_torch import Matcher, ScanConfig

        m = Matcher(self.specs, ScanConfig(**self.config["scan_config"]),
                    device=self.devices[0])
        m.finalize()
        return m

    def _saved_path(self, needles: np.ndarray) -> Path:
        h = hashlib.sha256(needles.tobytes())
        h.update(json.dumps(self.config["scan_config"], sort_keys=True)
                 .encode())
        return SAVED / f"{h.hexdigest()[:24]}.npz"

    def build(self, needles: np.ndarray) -> None:
        """The matcher and its plan, timed apart (``build_s`` is the
        build, or the load of a saved matcher)."""
        from php_aho_corasick_tpu_torch import ScanConfig
        from php_aho_corasick_tpu_torch.utils.serialization import (
            load_matcher, save_matcher)

        self.specs = [{"id": i, "value": row.tobytes()}
                      for i, row in enumerate(needles)]
        t0 = time.perf_counter()
        if self.traffic["matcher"] == "saved":
            path = self._saved_path(needles)
            if not path.exists():
                # the checkout's first run builds the file
                path.parent.mkdir(parents=True, exist_ok=True)
                part = path.with_name(path.stem + ".part.npz")
                m = self._new_matcher()
                save_matcher(m, part)
                m.close()
                os.replace(part, path)
                t0 = time.perf_counter()
            self.m = load_matcher(
                path, ScanConfig(**self.config["scan_config"]),
                device=self.devices[0])
        else:
            self.m = self._new_matcher()
        t1 = time.perf_counter()
        self.m.cascade_model  # the plan
        self.timings["build_s"] = t1 - t0
        self.timings["plan_s"] = time.perf_counter() - t1

    def plan(self) -> Dict[str, object]:
        """What the configuration states of the path, as the program
        planned it."""
        m = self.m
        cm = m.cascade_model
        out = {"table_format": m.table_format, "engine": None}
        if cm is not None:
            out.update({
                "engine": "cascade",
                "plan.mode": cm.plan.mode,
                "plan.q": cm.plan.q,
                "plan.stride": cm.plan.stride,
                "bloom_impl": cm.bloom_impl(),
                "records_ok": bool(cm.records_ok),
            })
        return out

    def load(self, units: Sequence[np.ndarray]) -> None:
        if self.traffic["units"] == "resident":
            self.units = [self.m.device_corpus([r.tobytes() for r in u])
                          for u in units]
        else:
            self.units = [[r.tobytes() for r in u] for u in units]

    def cards(self) -> int:
        """The cards the program's scans run on: a sharded handle's mesh,
        else the matcher's one device.  Refuses a mesh that is not one
        shard on each of the run's cards."""
        mesh = getattr(self.units[0], "mesh", None) if self.units else None
        if mesh is None:
            return 1
        used = [str(d) for d in mesh.devices]
        if self.devices[0].type == "cuda" and (
                len(mesh) != self.chips
                or sorted(used) != sorted(map(str, self.devices))):
            raise RuntimeError(f"the program's mesh spans {used}, the cell "
                               f"asks for {len(self.devices)} cards")
        return mesh.n_local

    def warm(self) -> None:
        """The first scan of each unit on its own (``match_arrays``), as
        the port's measurement tools warm a handle: it learns the
        capacities before a batched call."""
        if self.traffic["matcher"] == "per_call":
            return
        for u in self.units:
            self.m.match_arrays(u)

    def call(self, i: int) -> Tuple[List[int], List[dict]]:
        """Call ``i``: the units it scanned and one record dict each."""
        ks = call_units(self.traffic, i)
        units = [self.units[k] for k in ks]
        if self.traffic["matcher"] == "per_call":
            m = self._new_matcher()
            try:
                return ks, self.entry(m, units)
            finally:
                m.close()
        return ks, self.entry(self.m, units)

    def retries(self) -> int:
        return self.m.stats.capacity_retries

    def sync(self) -> None:
        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def close(self) -> None:
        """Free the program's state: handles, matcher, cached blocks."""
        self.units = []
        if self.m is not None:
            self.m.close()
        self.m = None
        self.stack.close()
        import gc

        gc.collect()
        for d in self.devices:
            if d.type == "cuda":
                with torch.cuda.device(d):
                    torch.cuda.empty_cache()


class Control:
    """The reference in the program's place, matching on the first
    ``prefix_bytes`` bytes of each needle alone (the configuration's
    q-gram): the exactness guarantee broken, as the filter's survivors
    taken for matches would break it."""

    def __init__(self, config: dict, traffic: dict, chips: int,
                 device: str = "cuda") -> None:
        self.config = config
        self.traffic = traffic
        self.devices = devices_of(chips, device)
        self.timings: Dict[str, float] = {}
        self.units: Sequence[np.ndarray] = []

    def build(self, needles: np.ndarray) -> None:
        from .reference.matcher import Needles

        t0 = time.perf_counter()
        self.needles = Needles([r.tobytes() for r in needles],
                               self.devices[0],
                               prefix_bytes=self.config["control"]["prefix_bytes"])
        self.timings["build_s"] = time.perf_counter() - t0
        self.timings["plan_s"] = 0.0

    def plan(self) -> Dict[str, object]:
        return {}

    def load(self, units: Sequence[np.ndarray]) -> None:
        self.units = units

    def cards(self) -> int:
        return len(self.devices)

    def call(self, i: int) -> Tuple[List[int], List[dict]]:
        from .reference.matcher import find

        ks = call_units(self.traffic, i)
        out = []
        for k in ks:
            r = find(self.units[k], self.needles)
            out.append({"doc": r["doc"], "pos": r["pos"],
                        "start_postion": r["start"], "pattern": r["pattern"]})
        return ks, out

    def warm(self) -> None:
        pass

    def retries(self) -> int:
        return 0

    def sync(self) -> None:
        pass

    def close(self) -> None:
        self.units = []


SYSTEMS = {"program": Program, "control": Control}
