"""Compiled automaton tables — the frozen, device-ready representation.

This is the TPU-native replacement for the reference's pointer trie
(``src/multifast/node.h:37-58``): after finalize, goto/fail transitions are
precomposed into a dense byte-class-compressed transition table so the scan
is a single gather per byte, instead of the reference's runtime failure-link
chasing (``src/multifast/ahocorasick.c:199-234``).

Layout decisions (TPU-first):

* **Byte-class compression** — columns are equivalence classes of bytes.
  Every byte that appears in no pattern behaves identically (goes to root
  from every state), so the table is ``[S, C]`` with
  ``C = distinct-used-bytes + 1`` instead of ``[S, 256]``.  For typical
  pattern sets this is a 10-40x size cut, which is what makes the table
  VMEM-resident on TPU.
* **Finality by state order** — states are renumbered so all *final* states
  (states whose failure-chain match set is non-empty, the flattened result
  of ``node_collect_matches``, ``src/multifast/node.c:424-441``) occupy the
  tail of the id space.  The scan kernel then tests finality with a single
  vectorized compare ``state >= final_start`` instead of a second gather.
* **CSR match emission** — ``emit_start``/``emit_pats`` map each final state
  to its matched pattern ids, ordered own-pattern-first then failure-chain
  (i.e. decreasing pattern length), which reproduces the reference's
  intra-position match ordering (visible in ``tests/test1.phpt:99-118``).
"""

from __future__ import annotations

import dataclasses
import io
from typing import Optional

import numpy as np


@dataclasses.dataclass
class CompiledAutomaton:
    """Frozen automaton: host numpy arrays, uploaded to device by the API."""

    #: ``[S, C]`` next-state table over byte classes (int32, or int16 when
    #: the state count fits — halves table bytes).
    table: np.ndarray
    #: ``[256]`` byte -> class id (class 0 = "appears in no pattern").
    byte_class: np.ndarray
    #: ``[S+1]`` CSR row starts into :attr:`emit_pats`.
    emit_start: np.ndarray
    #: ``[E]`` pattern ids, grouped per state, decreasing pattern length.
    emit_pats: np.ndarray
    #: ``[P]`` byte length of each accepted pattern.
    pat_lens: np.ndarray
    #: ``[S]`` trie depth of each state (= length of the state's string);
    #: used by the streaming-replace backlog cut (replace.c:529 analog).
    state_depth: np.ndarray
    #: first final state id; ``state >= final_start`` <=> final.
    final_start: int
    #: longest accepted pattern in bytes (drives halo width = max_len - 1).
    max_len: int

    @property
    def n_states(self) -> int:
        return self.table.shape[0]

    @property
    def n_classes(self) -> int:
        return self.table.shape[1]

    @property
    def n_patterns(self) -> int:
        return int(self.pat_lens.shape[0])

    @property
    def n_final(self) -> int:
        return self.n_states - self.final_start

    @property
    def emit_counts(self) -> np.ndarray:
        return (self.emit_start[1:] - self.emit_start[:-1]).astype(np.int32)

    @property
    def used_bytes(self) -> np.ndarray:
        """Sorted byte values used by any pattern; byte ``used_bytes[i]``
        has class ``i + 1`` (the compiler assigns classes in sorted byte
        order)."""
        return np.nonzero(self.byte_class)[0].astype(np.uint8)

    @property
    def table_bytes(self) -> int:
        return self.table.nbytes

    def is_final(self, states: np.ndarray) -> np.ndarray:
        """Vectorized finality predicate (same interface as
        CompressedAutomaton.is_final — table-format-agnostic walkers)."""
        return np.asarray(states) >= self.final_start

    def lookup(self, states: np.ndarray, classes: np.ndarray) -> np.ndarray:
        """Vectorized host transition (same interface as
        CompressedAutomaton.lookup, so host-side walkers — streaming state
        refresh, window re-walks — are table-format agnostic)."""
        return self.table[np.asarray(states), np.asarray(classes)].astype(
            np.int64
        )

    # ---- serialization (reference has none — automata are rebuilt each
    # process; worth having here since million-pattern builds are costly) ----

    def save(self, path) -> None:
        np.savez_compressed(
            path,
            table=self.table,
            byte_class=self.byte_class,
            emit_start=self.emit_start,
            emit_pats=self.emit_pats,
            pat_lens=self.pat_lens,
            state_depth=self.state_depth,
            final_start=np.int64(self.final_start),
            max_len=np.int64(self.max_len),
            format_version=np.int64(1),
        )

    @classmethod
    def load(cls, path) -> "CompiledAutomaton":
        with np.load(path) as z:
            if int(z["format_version"]) != 1:
                raise ValueError("unsupported automaton file version")
            return cls(
                table=z["table"],
                byte_class=z["byte_class"],
                emit_start=z["emit_start"],
                emit_pats=z["emit_pats"],
                pat_lens=z["pat_lens"],
                state_depth=z["state_depth"],
                final_start=int(z["final_start"]),
                max_len=int(z["max_len"]),
            )

    # ---- introspection (analog of ac_trie_display, ahocorasick.c:304) ----

    def describe(self) -> str:
        out = io.StringIO()
        out.write(
            f"CompiledAutomaton: {self.n_states} states "
            f"({self.n_final} final), {self.n_classes} byte classes, "
            f"{self.n_patterns} patterns, max_len={self.max_len}\n"
        )
        out.write(
            f"  table: {self.table.dtype.name}[{self.n_states},{self.n_classes}]"
            f" = {self.table_bytes / 1024:.1f} KiB; "
            f"emit entries: {self.emit_pats.shape[0]}\n"
        )
        return out.getvalue()

    def validate(self) -> None:
        """Internal consistency checks (used by tests and after load)."""
        S, C = self.table.shape
        assert self.byte_class.shape == (256,)
        assert self.byte_class.min() >= 0 and self.byte_class.max() < C
        assert self.table.min() >= 0 and self.table.max() < S
        assert self.emit_start.shape == (S + 1,)
        assert 0 <= self.final_start <= S
        counts = self.emit_counts
        assert (counts[: self.final_start] == 0).all()
        if self.final_start < S:
            assert (counts[self.final_start :] > 0).all()
        if self.emit_pats.size:
            assert self.emit_pats.min() >= 0
            assert self.emit_pats.max() < self.n_patterns
        assert self.state_depth.shape == (S,)
        assert self.state_depth[0] == 0
        if S > 1:
            assert int(self.state_depth.max()) == self.max_len


def state_dtype(n_states: int, allow_int16: bool) -> np.dtype:
    if allow_int16 and n_states <= np.iinfo(np.int16).max:
        return np.dtype(np.int16)
    return np.dtype(np.int32)


#: exception-class packing factor for CompressedAutomaton.meta:
#: ``meta = skip * EXC_PACK + (exc_class + 1)`` (0 = no exception).
#: 512 > max classes (257), leaving 22 bits for the dense-bank id.
EXC_PACK = 512


@dataclasses.dataclass
class CompressedAutomaton:
    """Sparse-row automaton for byte-dense signature-scale pattern sets.

    The dense ``[S, C]`` table explodes when both S (millions of states)
    and C (up to 257 byte classes) are large — 1M random-byte patterns is
    ~16 GB, beyond one chip's HBM (SURVEY §7 "Table memory at signature
    scale").  This is the promised compressed-row format: a **dense bank +
    single-exception rows** layout chosen for TPU execution — per byte the
    scan costs a fixed 3 gathers (no data-dependent failure chasing like
    the reference's ``ahocorasick.c:203-206``), vs 1 gather for the dense
    table:

    * **Dense states** (ids ``< n_dense``) keep a full precomposed row in
      ``dense_table`` — the root, shallow hubs, and any state whose row
      can't be expressed as "one exception over an ancestor's row".
    * **Sparse states** (ids ``>= n_dense``) store ONE exception
      ``(exc_class -> exc_target)`` plus a ``skip`` pointer to the dense
      state whose row equals theirs everywhere else.  By the AC closure
      recurrence ``row(s) = row(fail(s)) overlaid goto-edges(s)``, a
      state qualifies when its goto edges plus the not-yet-dense part of
      its failure chain's edges collapse to <= 1 entry — which is the
      common case exactly in the byte-dense regime (deep states have ~1
      edge and shallow failure targets).  Anything else is *promoted* to
      dense, so adversarial sets degrade in space, never in correctness
      (and alphabet-dense adversarial sets have small C, where the plain
      dense table is the right format anyway).

    Lookup (ops/scan_jax.py ``scan_states_compressed``)::

        meta   = meta_arr[s - D]              # packed (skip, exc_class)
        target = exc_target[s - D]
        row    = s if s < D else skip(meta)
        next   = target if (s >= D and cls == exc_class(meta))
                 else dense_table[row, cls]

    Finality: states are ordered [dense nonfinal][dense final][sparse
    nonfinal][sparse final]; a state is final iff ``s >= sparse_final_start
    or dense_final_start <= s < n_dense`` (two compares, no gather).
    """

    #: ``[D, C]`` full rows of the dense-bank states (int32).
    dense_table: np.ndarray
    #: ``[S - D]`` packed ``skip * EXC_PACK + exc_class + 1`` (int32);
    #: exc_class -1 (no exception) packs to 0.
    meta: np.ndarray
    #: ``[S - D]`` exception target state (int32; undefined when none).
    exc_target: np.ndarray
    #: ``[256]`` byte -> class id (class 0 = unused byte).
    byte_class: np.ndarray
    #: ``[S+1]`` CSR row starts into :attr:`emit_pats`.
    emit_start: np.ndarray
    #: ``[E]`` pattern ids per state, decreasing pattern length.
    emit_pats: np.ndarray
    #: ``[P]`` pattern byte lengths.
    pat_lens: np.ndarray
    #: ``[S]`` trie depth per state.
    state_depth: np.ndarray
    #: first final dense state (dense finals are [dense_final_start, D)).
    dense_final_start: int
    #: first final sparse state (sparse finals are [final_start, S)).
    final_start: int
    max_len: int

    @property
    def n_dense(self) -> int:
        return int(self.dense_table.shape[0])

    @property
    def n_states(self) -> int:
        return self.n_dense + int(self.meta.shape[0])

    @property
    def n_classes(self) -> int:
        return int(self.dense_table.shape[1])

    @property
    def n_patterns(self) -> int:
        return int(self.pat_lens.shape[0])

    @property
    def used_bytes(self) -> np.ndarray:
        return np.nonzero(self.byte_class)[0].astype(np.uint8)

    @property
    def table_bytes(self) -> int:
        return self.dense_table.nbytes + self.meta.nbytes + self.exc_target.nbytes

    def is_final(self, states: np.ndarray) -> np.ndarray:
        """Vectorized finality predicate (host-side mirror of the kernel's)."""
        s = np.asarray(states)
        return (s >= self.final_start) | (
            (s < self.n_dense) & (s >= self.dense_final_start)
        )

    def lookup(self, states: np.ndarray, classes: np.ndarray) -> np.ndarray:
        """Vectorized host transition (numpy mirror of the device step)."""
        s = np.asarray(states, dtype=np.int64)
        c = np.asarray(classes, dtype=np.int64)
        D = self.n_dense
        sp = np.maximum(s - D, 0)
        meta = self.meta[sp].astype(np.int64)
        key = meta % EXC_PACK - 1
        skip = meta // EXC_PACK
        row = np.where(s < D, s, skip)
        fb = self.dense_table[row, c].astype(np.int64)
        return np.where((s >= D) & (c == key), self.exc_target[sp], fb)

    def describe(self) -> str:
        S, D = self.n_states, self.n_dense
        return (
            f"CompressedAutomaton: {S} states ({D} dense rows, {S - D} "
            f"sparse), {self.n_classes} byte classes, {self.n_patterns} "
            f"patterns, max_len={self.max_len}; "
            f"{self.table_bytes / 2**20:.1f} MiB vs dense "
            f"{S * self.n_classes * 4 / 2**20:.1f} MiB\n"
        )

    def validate(self) -> None:
        S, D, C = self.n_states, self.n_dense, self.n_classes
        assert self.byte_class.shape == (256,)
        assert self.byte_class.min() >= 0 and self.byte_class.max() < C
        assert self.dense_table.min() >= 0 and self.dense_table.max() < S
        if self.meta.size:
            assert self.meta.min() >= 0
            assert (self.meta // EXC_PACK).max() < D
            key = self.meta % EXC_PACK - 1
            assert key.max() < C
            tgt = self.exc_target[key >= 0]
            if tgt.size:
                assert tgt.min() >= 0 and tgt.max() < S
        assert self.emit_start.shape == (S + 1,)
        assert 0 <= self.dense_final_start <= D
        assert D <= self.final_start <= S
        counts = (self.emit_start[1:] - self.emit_start[:-1]).astype(np.int64)
        fin = self.is_final(np.arange(S))
        assert (counts[fin] > 0).all() and (counts[~fin] == 0).all()
        assert self.state_depth.shape == (S,)

    def save(self, path) -> None:
        np.savez_compressed(
            path,
            dense_table=self.dense_table,
            meta=self.meta,
            exc_target=self.exc_target,
            byte_class=self.byte_class,
            emit_start=self.emit_start,
            emit_pats=self.emit_pats,
            pat_lens=self.pat_lens,
            state_depth=self.state_depth,
            dense_final_start=np.int64(self.dense_final_start),
            final_start=np.int64(self.final_start),
            max_len=np.int64(self.max_len),
            format_version=np.int64(2),
        )

    @classmethod
    def load(cls, path) -> "CompressedAutomaton":
        with np.load(path) as z:
            if int(z["format_version"]) != 2:
                raise ValueError("not a compressed-automaton file")
            return cls(
                dense_table=z["dense_table"],
                meta=z["meta"],
                exc_target=z["exc_target"],
                byte_class=z["byte_class"],
                emit_start=z["emit_start"],
                emit_pats=z["emit_pats"],
                pat_lens=z["pat_lens"],
                state_depth=z["state_depth"],
                dense_final_start=int(z["dense_final_start"]),
                final_start=int(z["final_start"]),
                max_len=int(z["max_len"]),
            )
