"""Profiling / tracing hooks.

The reference has no tracing beyond a debug trie dumper
(``ac_trie_display``, ``src/multifast/ahocorasick.c:304-307``) and
wall-clock prints in its benchmark.  Here:

* :func:`span` — the program's own spans at its layer boundaries (a scan
  call, its chain dispatch, each shard's chain, the filter and verify
  stages, the host's waits on the card, the finish, expansion, pack and
  upload, build and plan).  Off by default: ``span`` then returns one
  shared null context and reads no clock;
* :func:`recording` — turns spans on for a block and yields the
  :class:`Recording` that keeps them in memory.  Each span is also a
  profiler range named ``aho:<name>`` (``aho:<name>@cuda:<i>`` where it
  runs on one card of several), so a ``torch.profiler`` capture shows
  the program's ranges over the kernels they launched;
* :func:`wait` — the span of a point where the host blocks on the card,
  counted in ``ScanStats.host_waits`` whether recording or not;
* :func:`trace` — context manager around ``torch.profiler`` for capturing
  host and device traces of build/scan phases, with recording on (view
  with TensorBoard's profiler plugin or Perfetto);
* :func:`sync` — device-completion barrier: waits for the card, then
  fetches a checksum of the given tensors to the host;
* :func:`automaton_dot` — Graphviz export of a compiled automaton (the
  ``describe()``/display analog, useful for small pattern sets).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import TYPE_CHECKING, Dict, Iterator, List, Optional

if TYPE_CHECKING:
    from ..core.tables import CompiledAutomaton

#: prefix of the program's profiler ranges
PREFIX = "aho:"

#: what :func:`span` returns while nothing records
_NULL = contextlib.nullcontext()
#: the active :class:`Recording`, or None (the one global a span reads)
_active: Optional["Recording"] = None


class SpanRecord:
    """One span: ``name``, host-clock ``t0`` / ``t1``
    (``time.perf_counter``), its ``id``, the ``parent`` span's id (None
    for a root), the ``call`` id shared by every span under one root, and
    its ``attrs``.  ``t1`` is None while the span is open."""

    __slots__ = ("name", "t0", "t1", "id", "parent", "call", "attrs")

    def __init__(self, name, t0, id, parent, call, attrs) -> None:
        self.name = name
        self.t0 = t0
        self.t1: Optional[float] = None
        self.id = id
        self.parent = parent
        self.call = call
        self.attrs: Dict[str, object] = attrs

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (f"SpanRecord({self.name!r}, id={self.id}, "
                f"parent={self.parent}, call={self.call}, {self.attrs})")


class Recording:
    """The spans of one :func:`recording` block, in the order they
    opened.  Spans nest per thread; a root span starts a new call id."""

    def __init__(self) -> None:
        self.records: List[SpanRecord] = []
        self._open = threading.local()
        self._ids = 0
        self._calls = 0
        self._lock = threading.Lock()

    def _stack(self) -> List[SpanRecord]:
        st = getattr(self._open, "stack", None)
        if st is None:
            st = self._open.stack = []
        return st

    def _start(self, name: str, attrs: dict) -> SpanRecord:
        stack = self._stack()
        parent = stack[-1] if stack else None
        with self._lock:
            self._ids += 1
            if parent is None:
                self._calls += 1
            rec = SpanRecord(
                name, 0.0, self._ids, None if parent is None else parent.id,
                self._calls if parent is None else parent.call, attrs,
            )
            self.records.append(rec)
        stack.append(rec)
        rec.t0 = time.perf_counter()
        return rec

    def _end(self, rec: SpanRecord) -> None:
        rec.t1 = time.perf_counter()
        stack = self._stack()
        if stack and stack[-1] is rec:
            stack.pop()


def _profiler_range(label: str):
    """A profiler range of the function scope: the profiler links the
    device operations launched inside it by their launch time, as for a
    ``record_function`` range, but adds no device-side annotation (a
    ``record_function`` range, of the user scope, would add one)."""
    import torch

    return torch._C._profiler._RecordFunctionFast(label)


class _Span:
    __slots__ = ("recording", "name", "attrs", "label", "rec", "range")

    def __init__(self, recording: Recording, name: str, attrs: dict) -> None:
        self.recording = recording
        self.name = name
        self.attrs = attrs
        card = attrs.get("card")
        self.label = PREFIX + name
        if card is not None:
            card = str(card)
            attrs["card"] = card
            if card.startswith("cuda"):
                self.label += "@" + card

    def __enter__(self) -> SpanRecord:
        self.range = _profiler_range(self.label)
        self.range.__enter__()
        self.rec = self.recording._start(self.name, self.attrs)
        return self.rec

    def __exit__(self, *exc) -> None:
        self.recording._end(self.rec)
        self.range.__exit__(*exc)


def span(name: str, **attrs):
    """A context manager around one stage of the program.  While a
    :func:`recording` is active it keeps ``(name, t0, t1, id, parent,
    call, attrs)`` and opens the profiler range ``aho:<name>`` (with
    ``@<card>`` where ``attrs["card"]`` is a CUDA device); otherwise it
    is one shared null context.  Attribute values should be host values
    that cost nothing to compute: they are evaluated either way."""
    if _active is None:
        return _NULL
    return _Span(_active, name, attrs)


def wait(stats, *fetched):
    """The span of a point where the host blocks on the card: a sync, or
    a fetch of ``fetched`` (tensors, or counts of bytes) to the host;
    its attribute ``bytes`` is their size.  Counted in
    ``stats.host_waits`` (``ScanStats``; None counts nothing) whether
    recording or not."""
    if stats is not None:
        stats.host_waits += 1
    if _active is None:
        return _NULL
    nbytes = sum(x if isinstance(x, int) else x.numel() * x.element_size()
                 for x in fetched)
    return _Span(_active, "wait", {"bytes": nbytes})


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Record every span opened in this block; yields the
    :class:`Recording`.  Inside another recording block, yields that one
    (its records then hold both blocks' spans)."""
    global _active
    outer = _active
    rec = outer if outer is not None else Recording()
    _active = rec
    try:
        yield rec
    finally:
        _active = outer


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[Recording]:
    """Capture a torch.profiler trace of the enclosed block: host ops, the
    program's ``aho:`` ranges (recording is on for the block; yields its
    :class:`Recording`), and CUDA kernels when a card is present.  The
    trace is written under ``log_dir`` as
    ``<host>_<pid>.<ms>.pt.trace.json``."""
    import torch
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with recording() as rec, profile(
            activities=activities,
            on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield rec


def sync(*tensors) -> float:
    """Wait for the card to finish its work, then return a checksum of the
    given tensors fetched to the host (the fetch completes them whatever
    stream they were made on)."""
    import torch

    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    total = 0.0
    for a in tensors:
        total += float(torch.as_tensor(a).to(torch.float32).sum())
    return total


def automaton_dot(
    auto: CompiledAutomaton, max_states: int = 200
) -> str:
    """Graphviz dot of the goto-graph (edges whose target depth = source
    depth + 1), final states doubled — the ``node_display`` analog
    (``src/multifast/node.c:449-495``)."""
    if auto.n_states > max_states:
        raise ValueError(
            f"automaton too large to render ({auto.n_states} states; "
            f"limit {max_states})"
        )
    used = auto.used_bytes
    lines = ["digraph automaton {", "  rankdir=LR;", '  0 [label="root"];']
    for s in range(auto.n_states):
        if s >= auto.final_start:
            lines.append(f"  {s} [shape=doublecircle];")
        for c in range(1, auto.n_classes):
            t = int(auto.table[s, c])
            if auto.state_depth[t] == auto.state_depth[s] + 1:
                byte = used[c - 1]
                label = chr(byte) if 32 <= byte < 127 else f"0x{byte:02x}"
                lines.append(f'  {s} -> {t} [label="{label}"];')
    lines.append("}")
    return "\n".join(lines)
