"""Profiling / tracing hooks.

The reference has no tracing beyond a debug trie dumper
(``ac_trie_display``, ``src/multifast/ahocorasick.c:304-307``) and
wall-clock prints in its benchmark.  Here:

* :func:`trace` — context manager around ``torch.profiler`` for capturing
  host and device traces of build/scan phases (view with TensorBoard's
  profiler plugin or Perfetto);
* :func:`sync` — device-completion barrier: waits for the card, then
  fetches a checksum of the given tensors to the host;
* :func:`automaton_dot` — Graphviz export of a compiled automaton (the
  ``describe()``/display analog, useful for small pattern sets).
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

from ..core.tables import CompiledAutomaton


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a torch.profiler trace of the enclosed block: host ops, and
    CUDA kernels when a card is present.  The trace is written under
    ``log_dir`` as ``<host>_<pid>.<ms>.pt.trace.json``."""
    import torch
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield


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


class Timer:
    """Wall-clock phase timer with named laps (benchmark helper)."""

    def __init__(self) -> None:
        self.laps = {}
        self._t = time.time()

    def lap(self, name: str) -> float:
        now = time.time()
        dt = now - self._t
        self.laps[name] = self.laps.get(name, 0.0) + dt
        self._t = now
        return dt


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
