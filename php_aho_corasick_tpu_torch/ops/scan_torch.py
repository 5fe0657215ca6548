"""Device scan primitives in PyTorch: byte classification, the dense
DFA walk and the fixed-capacity compaction every scan ends with.

Counterpart of the JAX package's ``ops/scan_jax.py`` (the dense 1-gram
engine and the pieces the resident-corpus records path runs).  Everything
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

INT32_MAX = 2**31 - 1

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
    B, L = states.shape
    t_idx = torch.arange(L, dtype=torch.int32, device=states.device)
    final = (
        (states >= final_start)
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
