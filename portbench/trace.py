"""The traced run's instruments: spans around the system's entry points,
and the reduction of a ``torch.profiler`` slice to counts and times.

Spans are the benchmark's own: in a traced run only, :meth:`Spans.install`
replaces module or class attributes named ``"module:attr"`` or
``"module:Class.attr"`` by wrappers that take the host clock around each
call, note what the metric's reader asks of the arguments, and open a
``torch.profiler.record_function`` range named ``pb:<span>``, so that the
profiler links the device operations launched inside to the span.  The
system's code is not edited, and everything is put back on exit.  Events
stay in memory; nothing is written to disk.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import re
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

PREFIX = "pb:"


class Spans:
    """Host-clock records ``(name, t0, t1, note, phase)`` of every
    wrapped call and every harness span; ``phase`` is the run's phase
    when the span opened: ``"setup"``, ``"window"`` or ``"slice"`` (the
    window's profiled calls)."""

    def __init__(self) -> None:
        self.records: List[tuple] = []
        self.phase = "setup"

    def add(self, name: str, t0: float, t1: float, note=None) -> None:
        self.records.append((name, t0, t1, note, self.phase))

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        with torch.profiler.record_function(PREFIX + name):
            try:
                yield
            finally:
                self.add(name, t0, time.perf_counter())

    def _wrap(self, fn: Callable, name: str, note: Optional[Callable]):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            n = note(fn, args, kwargs) if note is not None else None
            t0 = time.perf_counter()
            with torch.profiler.record_function(PREFIX + name):
                try:
                    return fn(*args, **kwargs)
                finally:
                    self.add(name, t0, time.perf_counter(), n)

        return inner

    @contextlib.contextmanager
    def install(self, spans: Dict[str, dict]) -> Iterator[None]:
        """Wrap every target of ``spans`` (``name -> {"targets": [...],
        "note": fn}``) for the duration of the block."""
        undo = []
        try:
            for name, s in spans.items():
                for target in s["targets"]:
                    mod_name, attr = target.split(":")
                    owner = importlib.import_module(mod_name)
                    *path, leaf = attr.split(".")
                    for p in path:
                        owner = getattr(owner, p)
                    raw = owner.__dict__[leaf] if isinstance(owner, type) \
                        else getattr(owner, leaf)
                    if isinstance(raw, (staticmethod, classmethod)):
                        new = type(raw)(self._wrap(raw.__func__, name,
                                                   s["note"]))
                    else:
                        new = self._wrap(raw, name, s["note"])
                    setattr(owner, leaf, new)
                    undo.append((owner, leaf, raw))
            yield
        finally:
            for owner, leaf, raw in reversed(undo):
                setattr(owner, leaf, raw)

    def host_seconds(self, names, phase: str = "window") -> float:
        """Seconds of host clock inside any span of ``names`` (nested or
        overlapping spans counted once) opened in ``phase``."""
        iv = sorted((t0, t1) for n, t0, t1, _, p in self.records
                    if n in names and p == phase)
        total, end = 0.0, float("-inf")
        for t0, t1 in iv:
            if t1 <= end:
                continue
            total += t1 - max(t0, end)
            end = t1
        return total

    def count(self, name: str, phase: str = "window") -> int:
        return sum(1 for n, *_, p in self.records if n == name and p == phase)

    def notes(self, name: str, phase: str = "slice") -> list:
        return [nt for n, _, _, nt, p in self.records
                if n == name and p == phase and nt is not None]


#: host-side CUDA runtime calls that put an operation on a stream
LAUNCH = re.compile(r"^cu(da)?\w*(Launch|Memcpy|Memset)")


def _raw_events(events) -> List[tuple]:
    """``(name, on_device, device_index, start_us, end_us, correlation,
    linked_correlation)`` of each raw profiler event."""
    out = []
    for e in events:
        start = e.start_ns() / 1e3
        out.append((e.name(), str(e.device_type()).endswith("CUDA"),
                    e.device_index(), start, start + e.duration_ns() / 1e3,
                    e.correlation_id(), e.linked_correlation_id()))
    return out


def _union(iv: List[Tuple[float, float]], lo: float, hi: float
           ) -> Tuple[float, List[Tuple[float, float]]]:
    """Covered length of intervals ``iv`` clipped to ``[lo, hi]``, and
    the gaps between them."""
    total, end, gaps = 0.0, lo, []
    for a, b in sorted(iv):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if a > end:
            gaps.append((end, a))
        if b > end:
            total += b - max(a, end)
            end = b
    if hi > end:
        gaps.append((end, hi))
    return total, gaps


def _outermost(ranges: List[Tuple[float, float]]) -> np.ndarray:
    """Ranges of one name with those inside another dropped, sorted."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(ranges):
        if out and a <= out[-1][1]:
            continue
        out.append((a, b))
    return np.array(out, dtype=np.float64).reshape(-1, 2)


def reduce_profile(events, n_calls: int) -> dict:
    """The profiled slice (``events``: the profiler's raw events, a
    ``pb:slice`` range around ``n_calls`` calls) as counts and times.

    A device operation (kernel, copy, set; the device side of a ``pb:``
    range is no operation) belongs to a span when the host call that
    launched it (the CUDA runtime event its correlation id names) started
    inside one of the span's ranges.

    - ``window_us``: the slice's length; ``busy_us``: per card, the time in
      which some device operation ran;
    - ``device_ops``: device operations run in the slice;
    - ``spans``: per span name, the device microseconds and operations
      launched inside its ranges, and the ranges' count;
    - ``top_ops``: device time by operation name; ``gaps``: the longest
      idle gaps of any card, each with the innermost span the host was in;
    - ``linked_ops``: device operations whose launch was found.
    """
    raw = _raw_events(events)
    slices = [r for r in raw if r[0] == PREFIX + "slice" and not r[1]]
    if not slices:
        raise RuntimeError("the profile holds no pb:slice range")
    lo, hi = slices[0][3], slices[0][4]
    ops = [r for r in raw if r[1] and not r[0].startswith(PREFIX)
           and r[4] >= lo and r[3] <= hi]
    launches = [r for r in raw if not r[1] and LAUNCH.match(r[0])]
    host = [r for r in raw if not r[1] and r[0].startswith(PREFIX)]
    # which of the two ids names the launch differs between versions:
    # take the pairing that links more operations
    by_corr = {r[5]: r[3] for r in launches}
    linked_a = [by_corr.get(r[6]) for r in ops]
    linked_b = [by_corr.get(r[5]) for r in ops]
    launched = max((linked_a, linked_b),
                   key=lambda xs: sum(x is not None for x in xs))
    t_launch = np.array([np.nan if t is None else t for t in launched])
    dur = np.array([r[4] - r[3] for r in ops])
    spans: Dict[str, dict] = {}
    for name in sorted({r[0] for r in host}):
        rng = _outermost([(r[3], r[4]) for r in host if r[0] == name])
        inside = np.zeros(len(ops), dtype=bool)
        if len(ops) and len(rng):
            k = np.searchsorted(rng[:, 0], t_launch, side="right") - 1
            ok = (k >= 0) & ~np.isnan(t_launch)
            kk = np.where(ok, k, 0)
            inside = ok & (t_launch <= rng[kk, 1])
        spans[name[len(PREFIX):]] = {
            "device_us": float(dur[inside].sum()) if len(ops) else 0.0,
            "ops": int(inside.sum()), "count": len(rng)}
    dev_iv: Dict[int, List[Tuple[float, float]]] = {}
    by_name: Dict[str, float] = {}
    for name, _, dev, a, b, _, _ in ops:
        dev_iv.setdefault(dev, []).append((a, b))
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    busy, gaps = {}, []
    for dev, iv in dev_iv.items():
        busy[dev], g = _union(iv, lo, hi)
        gaps.extend((b - a, a, b, dev) for a, b in g)
    gaps.sort(reverse=True)
    labelled = []
    for length, a, b, dev in gaps[:10]:
        mid = (a + b) / 2
        inner = [(r[3], r[0]) for r in host if r[3] <= mid <= r[4]]
        label = max(inner)[1][len(PREFIX):] if inner else "outside any span"
        if len(dev_iv) > 1:
            label += f"@cuda:{dev}"
        labelled.append([label, length / 1e6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_us": hi - lo,
        "busy_us": busy,
        "device_ops": len(ops),
        "calls": n_calls,
        "spans": spans,
        "linked_ops": int((~np.isnan(t_launch)).sum()) if len(ops) else 0,
        "top_ops": [[name[:160], us / 1e6] for name, us in top],
        "gaps": labelled,
    }
