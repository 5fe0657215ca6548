"""Streaming search-and-replace — counterpart of the JAX package's
``replace.py``, and capability parity with the reference's MultiFast
replace engine (``src/multifast/replace.c``), which exists at the
C layer but was never exposed through PHP (``php_ahocorasick.c:467-470``
sets ``rtext = NULL``).

Semantics reproduced:

* **NORMAL mode** (``replace.h:34-40``): a longer match swallows shorter
  matches nested inside it — while booking a new nominee, pending nominees
  whose start is >= the new start are discarded (``replace.c:251-268``);
  non-nested overlaps are all replaced.
* **LAZY mode** (``replace.h:41-46``): first match wins — a new nominee
  overlapping the previous booked one (or an already-replaced region) is
  ignored (``replace.c:235-249``); consequently short factors nullify the
  long patterns containing them.
* Per position, the booked pattern is the *longest* matching pattern that
  has a replacement (the reference's per-node ``to_be_replaced`` bookmark,
  ``node_book_replacement``, ``src/multifast/node.c:337-362`` — here: the
  first entry of the final state's CSR list with a replacement, since CSR
  rows are ordered by decreasing length).
* **Backlog** (``replace.h:71-75``): in streaming mode, output is held back
  past the cut point where a pattern prefix might still be completed by the
  next chunk.  The cut is reference-exact: ``base_position -
  depth(last_node)`` (``replace.c:529``), available because the stream
  scanner carries the DFA state across feeds (stream.py).

The scan itself is :meth:`Matcher.match` (one-shot) or the stream scanner
(streaming); splicing is host-side and proportional to match count, not
corpus size.
"""

from __future__ import annotations

from itertools import groupby
from typing import Dict, List, Optional, Tuple, Union

from .errors import AhoError

Text = Union[str, bytes, bytearray]

MODES = ("normal", "lazy", "default")


def _as_bytes(x: Text) -> bytes:
    return x.encode("utf-8") if isinstance(x, str) else bytes(x)


def _normalize_replacements(replacements: Dict[Text, Text]) -> Dict[bytes, bytes]:
    return {_as_bytes(k): _as_bytes(v) for k, v in replacements.items()}


class _Booker:
    """Nominee booking + splicing shared by one-shot and streaming paths.

    Nominees are ``(start, end, rtext)`` in global stream coordinates.
    """

    def __init__(self, mode: str) -> None:
        if mode not in MODES:
            raise ValueError(f"unknown replace mode: {mode!r}")
        self.lazy = mode == "lazy"
        self.noms: List[Tuple[int, int, bytes]] = []
        self.curser = 0

    def book(self, start: int, end: int, rtext: bytes) -> None:
        if self.lazy:
            if start < self.curser:
                return  # overlaps an already-replaced region
            if self.noms and start < self.noms[-1][1]:
                return  # overlaps the pending previous nominee
        else:  # NORMAL: the new (longer) match swallows nested factors
            while self.noms and start <= self.noms[-1][0]:
                self.noms.pop()
        self.noms.append((start, end, rtext))

    def splice(self, pending: bytearray, pending_off: int, to_pos: int) -> bytes:
        """Replace booked nominees up to ``to_pos`` (exclusive start bound),
        consuming from ``pending`` (whose first byte is stream offset
        ``pending_off``).  Mirrors ``mf_repdata_do_replace``
        (``replace.c:403-455``)."""
        out = bytearray()
        consumed = 0
        for start, end, rtext in self.noms:
            if start >= to_pos:
                break
            if start > self.curser:
                # factor between the previous replacement and this match
                # (guard: an overlapping nominee contributes no factor, and a
                # negative slice index must never reach the buffer)
                out += pending[self.curser - pending_off : start - pending_off]
            out += rtext
            self.curser = max(self.curser, end)
            consumed += 1
        del self.noms[:consumed]
        if to_pos > self.curser:
            out += pending[self.curser - pending_off : to_pos - pending_off]
            self.curser = to_pos
        return bytes(out)


def _nominee_for_group(group: List[dict], rmap: Dict[bytes, bytes]):
    """Longest pattern at this end position that has a replacement."""
    for r in group:  # records at one position are ordered longest-first
        v = _as_bytes(r["value"])
        rt = rmap.get(v)
        if rt is not None:
            return r["pos"] - len(v), r["pos"], rt
    return None


class ReplaceStream:
    """Incremental replace over a chunked stream (see module docstring).

    ``feed`` returns the next spliced output bytes; ``flush`` returns the
    remainder (the ``multifast_rep_flush(keep=0)`` analog,
    ``replace.c:553-568``).
    """

    def __init__(
        self,
        matcher,
        replacements: Dict[Text, Text],
        mode: str = "normal",
    ) -> None:
        self._m = matcher
        self._rmap = _normalize_replacements(replacements)
        matcher.finalize() if not matcher.finalized else None
        vals = {p.value for p in matcher._patterns}
        if not any(k in vals for k in self._rmap):
            raise AhoError(
                "automaton has no to-be-replaced patterns"
            )  # reference: multifast_replace -> -2 (replace.c:483-484)
        self._booker = _Booker(mode)
        self._scanner = matcher.stream()
        self._pending = bytearray()
        self._pending_off = 0

    def feed(self, data: Text) -> bytes:
        data = _as_bytes(data)
        if not data:
            return b""
        recs = self._scanner.feed(data)
        self._pending += data
        for _, group in groupby(recs, key=lambda r: r["pos"]):
            nom = _nominee_for_group(list(group), self._rmap)
            if nom:
                self._booker.book(*nom)
        # reference-exact backlog cut (``replace.c:529``): hold back only
        # the bytes the carried DFA state proves could still extend to a
        # match — ``depth(last_node)`` bytes, not a fixed ``max_len - 1``
        cut = max(self._scanner.base_position - self._scanner.state_depth, 0)
        out = self._booker.splice(self._pending, self._pending_off, cut)
        self._drop_consumed()
        return out

    def flush(self) -> bytes:
        """End of stream: splice everything remaining."""
        out = self._booker.splice(
            self._pending, self._pending_off, self._scanner.base_position
        )
        self._drop_consumed()
        return out

    def _drop_consumed(self) -> None:
        drop = self._booker.curser - self._pending_off
        if drop > 0:
            del self._pending[:drop]
            self._pending_off = self._booker.curser


def replace(
    matcher,
    text: Text,
    replacements: Dict[Text, Text],
    mode: str = "normal",
) -> Text:
    """One-shot replace.  Returns the same type as ``text`` (str input is
    UTF-8 round-tripped)."""
    was_str = isinstance(text, str)
    data = _as_bytes(text)
    rmap = _normalize_replacements(replacements)
    matcher.finalize() if not matcher.finalized else None
    vals = {p.value for p in matcher._patterns}
    if not any(k in vals for k in rmap):
        raise AhoError("automaton has no to-be-replaced patterns")
    booker = _Booker(mode)
    recs = matcher.match(data)
    for _, group in groupby(recs, key=lambda r: r["pos"]):
        nom = _nominee_for_group(list(group), rmap)
        if nom:
            booker.book(*nom)
    out = booker.splice(bytearray(data), 0, len(data))
    return out.decode("utf-8") if was_str else out
