"""Device scan primitives in PyTorch: byte classification, the DFA walks
(dense table, compressed table, k-gram table) and the fixed-capacity
compaction every scan ends with.

Counterpart of the JAX package's ``ops/scan_jax.py``.  Everything
here is plain tensor code that stays on the tensors' device and never
synchronises with the host: compaction uses ``torch.nonzero_static``,
whose output shape is fixed by ``size`` (plain ``torch.nonzero`` has to
ask the device for its count).

The DFA walk advances every row one byte per step,

    ``state[t+1] = table[state[t] * C + class(byte[t])]``

as a time-major Python loop of one gather per byte column (the
reference's ``lax.scan``); throughput comes from the batch of rows.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.tables import EXC_PACK

INT32_MAX = 2**31 - 1
INT32_MIN = -(2**31)

#: k-gram entry layout: low bits = end state, bit 30 = "some intermediate
#: position inside this cell reached a final state" (the host re-walks
#: flagged cells for exact positions; see models/kgram_dfa.py)
KGRAM_STATE_MASK = (1 << 30) - 1
KGRAM_MID_FLAG = 1 << 30

#: compare-select classification is used up to this many distinct bytes
CLASSIFY_SELECT_LIMIT = 32


def classify_bytes(chunks: torch.Tensor, used_bytes: torch.Tensor) -> torch.Tensor:
    """byte -> class id via compare-select: byte ``used_bytes[i]`` has
    class ``i + 1`` (the table compiler's class assignment), every other
    byte class 0."""
    cls = torch.zeros(chunks.shape, dtype=torch.int32, device=chunks.device)
    for i in range(used_bytes.shape[0]):
        cls = torch.where(chunks == used_bytes[i], i + 1, cls)
    return cls


def _classes(chunks, byte_class, used_bytes):
    if used_bytes.shape[0] <= CLASSIFY_SELECT_LIMIT:
        return classify_bytes(chunks, used_bytes)
    return byte_class[chunks.long()].to(torch.int32)


def _nonzero_static(flat: torch.Tensor, size: int) -> torch.Tensor:
    """Ascending indices of the first ``size`` true entries, INT32_MAX
    padded, as int64 (fixed shape: no host synchronisation)."""
    return torch.nonzero_static(flat, size=size, fill_value=INT32_MAX)[:, 0]


def blocked_nonzero(
    flat: torch.Tensor, capacity: int, blk: int = 8
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-level fixed-capacity compaction of a sparse boolean vector.

    Reduces ``blk``-element blocks first and compacts only flagged
    blocks; when the block-flag vector still dwarfs the capacity the
    block compaction recurses.  Returns ``(idx [capacity] int32
    ascending, INT32_MAX-padded, n_true int32)``; exact whenever
    ``n_true <= capacity``, and the first ``capacity`` true indices
    otherwise (the caller retries with a bigger capacity)."""
    n = flat.shape[0]
    n_true = flat.sum(dtype=torch.int32)
    if capacity * blk >= n:
        # dense regime: one direct compaction over the input
        return _nonzero_static(flat, capacity).to(torch.int32), n_true
    nb = -(-n // blk)
    pad = torch.zeros(nb * blk - n, dtype=torch.bool, device=flat.device)
    flat_p = torch.cat([flat, pad]).reshape(nb, blk)
    blk_any = flat_p.any(dim=1)
    if nb > 16 * capacity:
        bidx, _ = blocked_nonzero(blk_any, capacity, blk)
        bidx = bidx.long()
    else:
        bidx = _nonzero_static(blk_any, capacity)
    safe_b = torch.clamp(bidx, max=nb - 1)
    sub = flat_p[safe_b] & (bidx < INT32_MAX)[:, None]  # [capacity, blk]
    fin = _nonzero_static(sub.reshape(-1), capacity)
    safe_f = torch.clamp(fin, max=capacity * blk - 1)
    elem = safe_b[safe_f // blk] * blk + safe_f % blk
    idx = torch.where(fin < INT32_MAX, elem, INT32_MAX)
    return idx.to(torch.int32), n_true


def _walk(table32, cls_t, init_state, n_classes):
    """The time-major DFA loop: ``cls_t [L, B]`` classes, int32 table.
    Returns ``(states [B, L] int32, last [B])``; ``states`` is a
    transposed view of the ``[L, B]`` buffer the loop writes."""
    L, B = cls_t.shape
    states = torch.empty((L, B), dtype=torch.int32, device=cls_t.device)
    s = init_state.to(torch.int32)
    for t in range(L):
        torch.index_select(
            table32, 0, torch.add(cls_t[t], s, alpha=n_classes),
            out=states[t],
        )
        s = states[t]
    return states.t(), s


def scan_states(
    table_flat: torch.Tensor,  # [S*C] int16/int32
    byte_class: torch.Tensor,  # [256] int32
    used_bytes: torch.Tensor,  # [U] uint8 (sorted; classes 1..U)
    chunks: torch.Tensor,  # [B, L] uint8
    init_state: torch.Tensor,  # [B] int32
    n_classes: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the DFA over each row. Returns (states [B, L] int32, last [B])."""
    cls = _classes(chunks, byte_class, used_bytes)
    return _walk(
        table_flat.to(torch.int32), cls.t().contiguous(), init_state,
        n_classes,
    )


def carry_states(states, lengths, init_state):
    """State after the last *valid* byte of each row (``states[b,
    lengths[b]-1]``; ``init_state[b]`` for an empty row)."""
    last_t = torch.clamp(lengths - 1, min=0).long()
    carry = states.gather(1, last_t[:, None])[:, 0]
    return torch.where(lengths > 0, carry, init_state.to(torch.int32))


def scan_and_compact(
    table_flat: torch.Tensor,
    byte_class: torch.Tensor,
    used_bytes: torch.Tensor,
    chunks: torch.Tensor,  # [B, L] uint8
    init_state: torch.Tensor,  # [B] int32
    lengths: torch.Tensor,  # [B] int32 valid byte count per row
    emit_from: torch.Tensor,  # [B] int32 first in-row position allowed to emit
    final_start: torch.Tensor,  # scalar int32
    n_classes: int,
    capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Byte-at-a-time scan + device-side match compaction.

    Returns ``(match_idx [capacity], match_state [capacity], n_matches,
    carry_state [B])``: flattened ``b * L + t`` indices of final positions
    in ascending order, INT32_MAX-padded; ``n_matches`` is the *true*
    count (above ``capacity`` the caller retries).  Positions before
    ``emit_from`` (halo) or past ``lengths`` do not emit; ``carry_state``
    is the state after each row's last valid byte."""
    states, _ = scan_states(
        table_flat, byte_class, used_bytes, chunks, init_state, n_classes
    )
    carry = carry_states(states, lengths, init_state)
    idx, match_state, n_matches = compact_final_states(
        states, lengths, emit_from, final_start, capacity
    )
    return idx, match_state, n_matches, carry


def compact_final_states(states, lengths, emit_from, final_start, capacity):
    """Fixed-capacity compaction of final positions from a states matrix
    (shared by the dfa and tile engines)."""
    return _compact_final(states, states >= final_start, lengths, emit_from,
                          capacity)


def _compact_final(states, final, lengths, emit_from, capacity):
    """Compact the ``final`` positions of ``states`` inside each row's
    ``[emit_from, length)`` window: ``(idx, match_state, n_matches)``."""
    B, L = states.shape
    t_idx = torch.arange(L, dtype=torch.int32, device=states.device)
    final = (
        final
        & (t_idx >= emit_from[:, None])
        & (t_idx < lengths[:, None])
    )
    idx, n_matches = blocked_nonzero(final.reshape(-1), capacity)
    safe = torch.clamp(idx, max=B * L - 1).long()
    # 2-d gather: ``states`` may be a transposed view
    match_state = torch.where(
        idx < INT32_MAX, states[safe // L, safe % L], -1
    )
    return idx, match_state, n_matches


def compressed_step(state, cls, dense_flat, meta, exc_target, n_classes,
                    n_dense):
    """One transition of the compressed table
    (``core/tables.CompressedAutomaton``): 3 gathers (meta, exception
    target, dense fallback row) and no data-dependent control flow.
    ``meta >= 0``, so ``%`` and ``//`` decode it as the reference's jnp
    ops do; the dense-row index is taken in int64 (``D * C`` may pass
    2^31 at signature scale)."""
    sp = torch.clamp(state - n_dense, min=0).long()
    m = meta[sp]
    key = m % EXC_PACK - 1
    row = torch.where(state < n_dense, state, m // EXC_PACK)
    fb = dense_flat[row.long() * n_classes + cls]
    return torch.where((state >= n_dense) & (cls == key), exc_target[sp], fb)


def compressed_final(state, n_dense, dense_final_start, final_start):
    """The compressed numbering's finality: ``[dense nonfinal][dense
    final][sparse nonfinal][sparse final]``."""
    return (state >= final_start) | (
        (state < n_dense) & (state >= dense_final_start)
    )


def scan_states_compressed(
    dense_flat: torch.Tensor,  # [D*C] int32 dense-bank rows
    meta: torch.Tensor,  # [S-D] int32 skip * EXC_PACK + exc_class + 1
    exc_target: torch.Tensor,  # [S-D] int32
    byte_class: torch.Tensor,
    used_bytes: torch.Tensor,
    chunks: torch.Tensor,  # [B, L] uint8
    init_state: torch.Tensor,  # [B] int32
    n_classes: int,
    n_dense: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """DFA scan over the compressed table, one :func:`compressed_step` a
    byte column.  Returns ``(states [B, L] int32, last [B])``;
    ``states`` is a transposed view of the ``[L, B]`` buffer."""
    cls_t = _classes(chunks, byte_class, used_bytes).t().contiguous()
    L, B = cls_t.shape
    states = torch.empty((L, B), dtype=torch.int32, device=cls_t.device)
    s = init_state.to(torch.int32)
    for t in range(L):
        states[t] = compressed_step(s, cls_t[t], dense_flat, meta,
                                    exc_target, n_classes, n_dense)
        s = states[t]
    return states.t(), s


def scan_and_compact_compressed(
    dense_flat: torch.Tensor,
    meta: torch.Tensor,
    exc_target: torch.Tensor,
    byte_class: torch.Tensor,
    used_bytes: torch.Tensor,
    chunks: torch.Tensor,  # [B, L] uint8
    init_state: torch.Tensor,  # [B] int32
    lengths: torch.Tensor,  # [B] int32
    emit_from: torch.Tensor,  # [B] int32
    dense_final_start: torch.Tensor,  # scalar int32
    final_start: torch.Tensor,  # scalar int32
    n_classes: int,
    n_dense: int,
    capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compressed-table analog of :func:`scan_and_compact`, finality by
    :func:`compressed_final`."""
    states, _ = scan_states_compressed(
        dense_flat, meta, exc_target, byte_class, used_bytes, chunks,
        init_state, n_classes, n_dense,
    )
    carry = carry_states(states, lengths, init_state)
    final = compressed_final(states, n_dense, dense_final_start, final_start)
    idx, match_state, n_matches = _compact_final(
        states, final, lengths, emit_from, capacity
    )
    return idx, match_state, n_matches, carry


def kgram_decode(entry: torch.Tensor):
    """``(end_state int32, mid_flag)`` of k-gram table entries: int16
    tables keep the flag in the sign bit, int32 tables in bit 30."""
    if entry.dtype == torch.int16:
        return (entry & 0x7FFF).to(torch.int32), entry < 0
    return entry & KGRAM_STATE_MASK, (entry & KGRAM_MID_FLAG) != 0


def scan_and_compact_kgram(
    ktable: torch.Tensor,  # [S * C^k] int16/int32 packed entries
    byte_class: torch.Tensor,  # [256] int32
    used_bytes: torch.Tensor,  # [U] uint8
    chunks: torch.Tensor,  # [B, L] uint8, L % k == 0
    init_state: torch.Tensor,  # [B] int32
    lengths: torch.Tensor,  # [B] int32
    emit_from: torch.Tensor,  # [B] int32
    final_start: torch.Tensor,  # scalar int32
    n_classes: int,
    k: int,
    capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """k-bytes-a-gather scan + cell-level compaction.

    Cell ``j`` of row ``b`` covers positions ``[j*k, (j+1)*k)``.  A cell
    is flagged when its entry's mid-final flag is set or its end state is
    final, and it overlaps the row's ``[emit_from, length)`` window.  The
    walk packs "this cell holds a final position" into the sign bit of
    the state entering the cell, and compacts in its time-major ``[Lc,
    B]`` layout; the compacted indices are converted to ``b * Lc + t``
    (the host re-sorts them, ``ops/matches.expand_matches_kgram_arrays``).

    Returns ``(cell_idx [cap], prev_state [cap], n_cells, carry [B])``,
    equal to the reference's before the host sort."""
    B, L = chunks.shape
    assert L % k == 0, (L, k)
    n_cells_row = L // k
    dev = chunks.device
    cls = _classes(chunks, byte_class, used_bytes)
    code = cls[:, 0::k]
    for j in range(1, k):
        code = code * n_classes + cls[:, j::k]
    code_t = code.t().contiguous()  # [Lc, B]
    ck = n_classes**k
    flag = torch.tensor(INT32_MIN, dtype=torch.int32, device=dev)
    packed = torch.empty((n_cells_row, B), dtype=torch.int32, device=dev)
    state = init_state.to(torch.int32)
    for t in range(n_cells_row):
        ns, mid = kgram_decode(ktable[state.long() * ck + code_t[t]])
        packed[t] = torch.where(mid | (ns >= final_start), state | flag,
                                state)
        state = ns
    cell_t = torch.arange(n_cells_row, dtype=torch.int32, device=dev)[:, None]
    overlaps = (cell_t * k < lengths[None, :]) & (
        (cell_t + 1) * k > emit_from[None, :]
    )
    flagged = ((packed < 0) & overlaps).reshape(-1)
    idx, n_flagged = blocked_nonzero(flagged, capacity)
    valid = idx < INT32_MAX
    safe = torch.clamp(idx, max=B * n_cells_row - 1).long()
    out_prev = torch.where(
        valid, packed.reshape(-1)[safe] & KGRAM_STATE_MASK, -1
    )
    out_idx = torch.where(
        valid, (idx % B) * n_cells_row + idx // B, INT32_MAX
    )
    return out_idx, out_prev, n_flagged, state
