"""Host-side scan runtime: document packing and match expansion.

Bridges variable-length user haystacks and the fixed-shape device kernels in
:mod:`scan_torch`:

* **Packing** — documents are cut into rows of at most ``chunk_len`` payload
  bytes with a left *halo* of ``max_len - 1`` overlap bytes (the TPU-native
  replacement for the reference's sequential chunked streaming,
  ``ahocorasick.c:236-238``): the DFA state at any position depends on at
  most the previous ``max_len - 1`` bytes, so a chunk scanned from root with
  that much left context reproduces the exact state sequence of a full
  sequential scan.  Positions inside the halo are owned by the neighboring
  chunk and masked via ``emit_from``.
* **Expansion** — compacted device match positions (or flagged k-gram
  cells, re-walked through the 1-gram table) are expanded through the
  CSR emit tables into (doc, end_pos, pattern_ids) records, in reference
  scan order: ascending end position, and within one end position the
  state's own (longest) pattern before its failure-chain suffix factors
  (``node_collect_matches`` order, ``src/multifast/node.c:424-441``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from ..core.tables import CompiledAutomaton
from ..utils.profiling import span

ROW_ALIGN = 128


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class PackedRows:
    """Fixed-shape batch of scan rows plus per-row provenance."""

    chunks: np.ndarray  # [B, L] uint8
    lengths: np.ndarray  # [B] int32 (valid bytes in row; 0 for pad rows)
    emit_from: np.ndarray  # [B] int32 (first emitting in-row position)
    doc_id: np.ndarray  # [B] int32
    global_off: np.ndarray  # [B] int64 (doc offset of row position 0)

    @property
    def batch(self) -> int:
        return self.chunks.shape[0]

    @property
    def row_len(self) -> int:
        return self.chunks.shape[1]


def pack_documents(
    docs: Sequence[bytes],
    chunk_len: int,
    halo: int,
    batch_pad: int = 8,
    row_align: int = ROW_ALIGN,
) -> PackedRows:
    """Cut documents into halo-overlapped rows and pad to a fixed shape.

    Vectorized: one corpus concatenation + one fancy-gather builds the
    whole ``[B, L]`` batch (the python loop is per *document*, not per
    row/byte).

    ``row_align``: the packed row length ``L`` is rounded up to this
    (>= ROW_ALIGN, and forced to a multiple of it).  The sampled
    cascade's fused/grouped fast paths gate on ``stride | L``, and
    rounding only the *chunk* length cannot guarantee that once the
    halo and the 128-byte tile alignment are added — callers pass
    ``lcm(stride, 128)`` so the gate holds for every corpus shape
    (round-4 ADVICE.md low #2)."""
    meta: List[Tuple[int, int, int, int]] = []  # (doc, off, emit_from, len)
    doc_off: List[int] = []  # corpus offset of each row's doc
    pos = 0
    for d, doc in enumerate(docs):
        n = len(doc)
        if n == 0:
            pos += n
            continue
        if n <= chunk_len:
            meta.append((d, 0, 0, n))
            doc_off.append(pos)
        else:
            for start in range(0, n, chunk_len):
                row_start = max(0, start - halo)
                row_len = min(start + chunk_len, n) - row_start
                meta.append((d, row_start, start - row_start, row_len))
                doc_off.append(pos)
        pos += n

    B = max(_round_up(max(len(meta), 1), batch_pad), batch_pad)
    align = _round_up(max(row_align, ROW_ALIGN), ROW_ALIGN)
    L = _round_up(max((m[3] for m in meta), default=1), align)
    if B * L >= 2**31:
        raise ValueError(
            f"scan batch too large ({B} rows x {L} bytes overflows int32 "
            "cell indices); lower ScanConfig.max_launch_bytes or split the "
            "input documents"
        )
    chunks = np.zeros((B, L), dtype=np.uint8)
    lengths = np.zeros(B, dtype=np.int32)
    emit_from = np.zeros(B, dtype=np.int32)
    doc_id = np.full(B, -1, dtype=np.int32)
    global_off = np.zeros(B, dtype=np.int64)
    if meta:
        flat = np.frombuffer(b"".join(docs), dtype=np.uint8)
        mi = np.asarray(meta, dtype=np.int64)  # [R, 4]
        R = mi.shape[0]
        doc_id[:R] = mi[:, 0]
        global_off[:R] = mi[:, 1]
        emit_from[:R] = mi[:, 2]
        lengths[:R] = mi[:, 3]
        starts = np.asarray(doc_off, dtype=np.int64) + mi[:, 1]
        # per-row slice copies: a [B, L] fancy-gather index here costs
        # 8x the corpus in int64 intermediates (~1 GB per 128 MiB — the
        # round-5 cold-path profile measured the pack at ~20 MB/s);
        # 32k memcpy-sized slice assignments run at memory speed with
        # ~2 us of Python each
        for r in range(R):
            n = mi[r, 3]
            o = starts[r]
            chunks[r, :n] = flat[o : o + n]
    return PackedRows(chunks, lengths, emit_from, doc_id, global_off)


def merge_shard_buffers(
    idx2d: np.ndarray,  # [n_shards, capacity] global cell indices
    sts2d: np.ndarray,  # [n_shards, capacity]
    counts: np.ndarray,  # [n_shards] true per-shard match counts
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Concatenate per-shard compacted buffers into one ascending stream.

    Shards hold contiguous row blocks and entries are ascending within a
    shard, so shard-order concatenation is globally ascending.
    """
    parts_i = [idx2d[s, : counts[s]] for s in range(idx2d.shape[0])]
    parts_s = [sts2d[s, : counts[s]] for s in range(idx2d.shape[0])]
    return (
        np.concatenate(parts_i) if parts_i else np.zeros(0, np.int32),
        np.concatenate(parts_s) if parts_s else np.zeros(0, np.int32),
        int(counts.sum()),
    )


def csr_expand(
    auto: CompiledAutomaton,
    states: np.ndarray,  # [n] final states
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized CSR emit-table expansion: for each final state, all its
    pattern ids (own + failure-chain factors, ``node_collect_matches``
    order).  Returns ``(rec_of [total] int64 — index of the source record
    each pattern id belongs to — and pids [total])`` with no Python loop."""
    starts = auto.emit_start[states]
    cnt = (auto.emit_start[states + 1] - starts).astype(np.int64)
    total = int(cnt.sum())
    if total == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    rec_of = np.repeat(np.arange(states.shape[0], dtype=np.int64), cnt)
    # offset within each record's CSR row: global position minus the
    # record's first output slot
    first_out = np.concatenate(([0], np.cumsum(cnt)[:-1]))
    offs = np.repeat(starts - first_out, cnt) + np.arange(total)
    return rec_of, auto.emit_pats[offs].astype(np.int64)


def expand_matches_arrays(
    auto: CompiledAutomaton,
    packed: PackedRows,
    match_idx: np.ndarray,  # [capacity] int32, INT32_MAX-padded, ascending
    match_state: np.ndarray,  # [capacity] int32
    n_matches: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fully vectorized expansion of the compacted device output into
    ``(docs [N], end_pos [N], pids [N])`` arrays in reference emission
    order (ascending end position; within one end the state's own longest
    pattern first — the CSR rows are stored in that order).

    ``end_pos`` is the *exclusive* byte end offset within the document —
    the reference's ``pos`` field (``php_ahocorasick.c:555-560``).
    """
    if n_matches == 0:
        z = np.zeros(0, np.int64)
        return z, z, z
    with span("expand", records=n_matches):
        L = packed.row_len
        idx = match_idx[:n_matches]
        sts = match_state[:n_matches].astype(np.int64)
        rows = idx // L
        ts = idx % L
        end_pos = packed.global_off[rows] + ts + 1
        docs = packed.doc_id[rows].astype(np.int64)
        rec_of, pids = csr_expand(auto, sts)
        return docs[rec_of], end_pos[rec_of], pids


def expand_matches(
    auto: CompiledAutomaton,
    packed: PackedRows,
    match_idx: np.ndarray,
    match_state: np.ndarray,
    n_matches: int,
) -> Iterator[Tuple[int, int, np.ndarray]]:
    """Iterator facade over :func:`expand_matches_arrays` — yields
    ``(doc, end_pos, pattern_ids)`` per final position, in order."""
    if n_matches == 0:
        return
    L = packed.row_len
    idx = match_idx[:n_matches]
    sts = match_state[:n_matches]
    rows = idx // L
    ts = idx % L
    end_pos = packed.global_off[rows] + ts + 1
    docs = packed.doc_id[rows]
    starts = auto.emit_start[sts]
    ends = auto.emit_start[sts + 1]
    for i in range(n_matches):
        yield int(docs[i]), int(end_pos[i]), auto.emit_pats[starts[i] : ends[i]]


def expand_matches_kgram_arrays(
    auto: CompiledAutomaton,
    packed: PackedRows,
    k: int,
    cell_idx: np.ndarray,  # [capacity] flattened b * (L/k) + cell, ascending
    prev_state: np.ndarray,  # [capacity] state entering each flagged cell
    n_cells: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Re-walk flagged k-gram cells to exact per-position matches —
    vectorized end to end (k table steps over all flagged cells, then one
    CSR expansion); no per-record Python loop.

    The device only flags cells (k-byte windows) containing at least one
    final position.  Returns ``(docs, end_pos, pids)`` arrays in reference
    scan order (cells ascending row-major; positions ascending within a
    cell)."""
    if n_cells == 0:
        z = np.zeros(0, np.int64)
        return z, z, z
    Lc = packed.row_len // k
    cells = cell_idx[:n_cells].astype(np.int64)
    prevs = prev_state[:n_cells].astype(np.int64)
    # the device compacts in time-major order; restore row-major scan order
    order = np.argsort(cells, kind="stable")
    cells = cells[order]
    prevs = prevs[order]
    rows = cells // Lc
    tc = cells % Lc
    byte_mat = packed.chunks[
        rows[:, None], tc[:, None] * k + np.arange(k)[None, :]
    ]  # [n, k]
    cls_mat = auto.byte_class[byte_mat]
    table = auto.table
    fs = auto.final_start
    row_emit_from = packed.emit_from[rows]
    row_len = packed.lengths[rows]
    s = prevs
    valid_j = np.empty((k, n_cells), dtype=bool)
    state_j = np.empty((k, n_cells), dtype=np.int64)
    pos_j = np.empty((k, n_cells), dtype=np.int64)
    for j in range(k):
        s = table[s, cls_mat[:, j]].astype(np.int64)
        pos = tc * k + j
        valid_j[j] = (s >= fs) & (pos >= row_emit_from) & (pos < row_len)
        state_j[j] = s
        pos_j[j] = pos
    # flatten cell-major then j (transpose): exact scan order
    sel = valid_j.T.reshape(-1)
    states_f = state_j.T.reshape(-1)[sel]
    ends_f = (
        packed.global_off[rows][:, None] + pos_j.T + 1
    ).reshape(-1)[sel]
    docs_f = np.repeat(packed.doc_id[rows].astype(np.int64), k)[sel]
    rec_of, pids = csr_expand(auto, states_f)
    return docs_f[rec_of], ends_f[rec_of], pids


def expand_matches_kgram(
    auto: CompiledAutomaton,
    packed: PackedRows,
    k: int,
    cell_idx: np.ndarray,
    prev_state: np.ndarray,
    n_cells: int,
) -> Iterator[Tuple[int, int, np.ndarray]]:
    """Iterator facade over :func:`expand_matches_kgram_arrays`."""
    docs, ends, pids = expand_matches_kgram_arrays(
        auto, packed, k, cell_idx, prev_state, n_cells
    )
    for i in range(docs.shape[0]):
        yield int(docs[i]), int(ends[i]), pids[i : i + 1]
