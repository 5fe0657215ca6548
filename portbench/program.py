"""The program's own spans and wait counter, for the per-layer metrics
that read them (``metrics/chain_dispatch_ms_per_call.py``,
``host_wait_ms_per_call.py``, ``host_waits_per_call.py``,
``corpus_load_s.py``).

Spans: the program's recorder (``php_aho_corasick_tpu_torch.utils.
profiling.recording``) keeps every span in memory while it is on.  These
metrics' readers are loaded in a traced run only, before set-up, and each
calls :func:`record` as it loads, so a fresh recording runs from set-up's
start to the end of the process: spans opened in set-up, in the window
and in the profiled slice are kept, on ``time.perf_counter``, the clock
the harness times its calls with.  A record's phase is read from the
harness's own bounds: set-up before the window's first call starts, the
window up to its last call's end.  An untraced run loads no per-layer
reader, so there the program records nothing.

Counter: ``ScanStats.host_waits`` of the run's matcher, noted by the
wrapper :data:`COUNTER_SPANS` puts on ``Program.retries``, which the
harness calls once just before the window's first call and once just
after its last (and in set-up, never in the profiled slice).

A program without the recorder or the counter gives nothing to read:
the readers then return None.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

#: the recording of the current run, or None (no recorder in the program)
RECORDING = None
_OPEN = None


def record() -> None:
    """Start a fresh recording of the program's spans, left on for the
    rest of the process (the one before it, if any, is stopped)."""
    global RECORDING, _OPEN
    try:
        from php_aho_corasick_tpu_torch.utils.profiling import recording
    except ImportError:
        return
    stop()
    _OPEN = recording()
    RECORDING = _OPEN.__enter__()


def stop() -> None:
    """Turn the program's recorder off again (its records stay readable
    in :data:`RECORDING`)."""
    global _OPEN
    if _OPEN is not None:
        _OPEN.__exit__(None, None, None)
        _OPEN = None


def _window(run) -> Tuple[float, float]:
    return (min(t0 for t0, _, _ in run.calls),
            max(t1 for _, t1, _ in run.calls))


def _union(iv: List[Tuple[float, float]]) -> float:
    """Length of the union of intervals ``iv`` (nested or overlapping
    spans counted once)."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(iv):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def _spans(names: Iterable[str], lo: float, hi: float
           ) -> List[Tuple[float, float]]:
    names = set(names)
    return [(r.t0, r.t1) for r in RECORDING.records
            if r.name in names and r.t1 is not None and lo <= r.t0 <= hi]


def window_ms_per_call(run, names: Iterable[str]) -> Optional[float]:
    """Host milliseconds inside the program's spans of ``names`` that
    opened in the window, over its calls."""
    if RECORDING is None or not run.n_calls:
        return None
    iv = _spans(names, *_window(run))
    if not iv:
        return None
    return _union(iv) * 1e3 / run.n_calls


def setup_seconds(run, names: Iterable[str]) -> Optional[float]:
    """Host seconds inside the program's spans of ``names`` that opened
    in set-up."""
    if RECORDING is None or not run.calls:
        return None
    iv = _spans(names, float("-inf"), _window(run)[0])
    if not iv:
        return None
    return _union(iv)


def _host_waits(fn, args, kwargs) -> Optional[int]:
    """``ScanStats.host_waits`` of the matcher of the ``Program`` whose
    method is called, or None (no matcher, or no such counter)."""
    m = getattr(args[0], "m", None) if args else None
    return getattr(getattr(m, "stats", None), "host_waits", None)


#: the wrapper that notes the counter (``SPANS`` and ``NOTES`` of a reader)
COUNTER_SPANS = {"program.counters": ["portbench.system:Program.retries"]}
COUNTER_NOTES = {"program.counters": _host_waits}


def window_count(run) -> Optional[int]:
    """``host_waits`` gained in the window: its note after the window
    less its note before."""
    notes = run.spans.notes("program.counters", "window")
    if len(notes) != 2:
        return None
    return notes[1] - notes[0]
