"""Tile-engine DFA scan: the hand-written Hopper kernel and its plain
PyTorch version.

Counterpart of the JAX package's ``ops/scan_pallas.py`` (its
``scan_states_tile`` Pallas kernel).  For small automata (``S * C <=
4096`` table entries) the whole transition table fits in shared memory,
and every row of the batch walks its bytes through it:

    ``states[b, t] = table[states[b, t-1] * C + class(chunks[b, t])]``

On a CUDA tensor :func:`scan_states_tile` launches
``csrc/scan_states_tile.cu``; on a CPU tensor it runs
:func:`_scan_states_tile_torch`, the dense engine's loop
(``ops/scan_torch.py``), which the tests hold bit for bit against the JAX
package's kernel in interpret mode.

The kernel may cut each row into segments walked in parallel
(:func:`tile_segment_plan`).  A segment after the first starts from state
0 a few bytes early; that is exact only for an Aho-Corasick DFA whose
patterns are at most ``sync_len`` bytes long, so the caller that knows
its table is one passes ``sync_len`` and every other call walks each row
in one piece.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ._build import hand_kernel
from .filter_cuda import _check
from .scan_torch import carry_states, scan_states

#: most table entries the kernel stages in shared memory (widened to
#: int32: 16 KiB) — the tile engine's eligibility bound
TILE_MAX_ENTRIES = 4096
#: shortest segment, and the step, in bytes, that segments are cut at
TILE_MIN_SEGMENT, TILE_STEP = 64, 16


def tile_segment_plan(L: int, sync_len: Optional[int]) -> Tuple[int, int, int]:
    """``(seg_len, n_seg, warm)`` of the kernel's cut of ``L``-byte rows.

    Segment ``k`` covers bytes ``[k * seg_len, min(L, (k+1) * seg_len))``;
    segment 0 walks from the row's initial state, a later one from state 0
    over the ``warm`` bytes before it (``sync_len`` rounded up to the
    step), which is at most a quarter of a segment.  Without ``sync_len``,
    or where one segment covers the row, a row is one segment."""
    if sync_len is not None and sync_len < 0:
        raise ValueError(f"sync_len={sync_len}: must be >= 0")
    if sync_len is None:
        return L, 1, 0
    warm = -(-sync_len // TILE_STEP) * TILE_STEP
    seg_len = max(TILE_MIN_SEGMENT, 4 * warm)
    if seg_len >= L:
        return L, 1, 0
    return seg_len, -(-L // seg_len), warm


def _scan_states_tile_torch(
    table_flat, byte_class, used_bytes, chunks, init_state, n_classes,
    lengths=None, sync_len=None,
):
    """Plain PyTorch version of the tile kernel (the dense engine's walk,
    each row in one piece: ``sync_len`` changes nothing); runs on any
    device."""
    states, last = scan_states(
        table_flat, byte_class, used_bytes, chunks, init_state, n_classes
    )
    if chunks.shape[1] == 0:
        return states, init_state.to(torch.int32)
    if lengths is None:
        return states, last
    return states, carry_states(states, lengths, init_state)


_P, _I = ctypes.c_void_p, ctypes.c_int
#: C signature of ``scan_states_tile_launch`` (csrc/scan_states_tile.cu)
_ARGTYPES = [
    _P, _I,  # table, entries
    _P, _P, _P, _P,  # byte_class, chunks, init_state, lengths
    _I, _I, _I,  # B, L, n_classes
    _I, _I, _I,  # seg_len, n_seg, warm
    _P, _P,  # states, carry
    _P,  # stream
]


@hand_kernel(plain=_scan_states_tile_torch, on="chunks")
def scan_states_tile(
    kernel,
    table_flat: torch.Tensor,  # [S*C] int32 (int16 is widened)
    byte_class: torch.Tensor,  # [256] int32
    used_bytes: torch.Tensor,  # [U] uint8
    chunks: torch.Tensor,  # [B, L] uint8
    init_state: torch.Tensor,  # [B] int32
    n_classes: int,
    lengths: Optional[torch.Tensor] = None,  # [B] int32; None: full rows
    sync_len: Optional[int] = None,  # longest pattern of an AC table
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tile-engine DFA scan. Returns ``(states [B, L] int32, carry [B])``.

    ``carry[b]`` is the state after the last *valid* byte
    (``states[b, lengths[b]-1]``; ``init_state[b]`` for empty rows), not
    ``states[:, -1]``, which pad bytes poison for rows shorter than ``L``.

    ``sync_len`` says that ``table_flat`` is an Aho-Corasick DFA (its
    state after any text depends only on the last ``sync_len`` bytes) and
    lets the kernel walk segments of a row in parallel; leave it ``None``
    for any other table.  The result is the same either way.

    A CUDA ``chunks`` launches the Hopper kernel (counted in
    ``scan_states_tile.launches``, and in ``segmented_launches`` where it
    cut the rows); a CPU one runs the plain version."""
    dev = chunks.device
    B, L = chunks.shape
    seg_len, n_seg, warm = tile_segment_plan(L, sync_len)
    n_entries = table_flat.shape[0]
    if not 1 <= n_entries <= TILE_MAX_ENTRIES or n_entries % n_classes:
        raise ValueError(
            f"scan_states_tile: {n_entries} table entries (at most "
            f"{TILE_MAX_ENTRIES}, a multiple of n_classes={n_classes})"
        )
    if table_flat.dtype == torch.int16:
        table_flat = table_flat.to(torch.int32)
    _check("table_flat", table_flat, (n_entries,), dev)
    _check("byte_class", byte_class, (256,), dev)
    _check("chunks", chunks, (B, L), dev, dtype=torch.uint8)
    _check("init_state", init_state, (B,), dev)
    if lengths is not None:
        _check("lengths", lengths, (B,), dev)
    states = torch.empty((B, L), dtype=torch.int32, device=dev)
    carry = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return states, carry
    kernel.launch(
        kernel.entry_point("scan_states_tile_launch", _ARGTYPES), dev,
        table_flat.data_ptr(), n_entries, byte_class.data_ptr(),
        chunks.data_ptr(), init_state.data_ptr(),
        lengths.data_ptr() if lengths is not None else None,
        B, L, n_classes, seg_len, n_seg, warm, states.data_ptr(),
        carry.data_ptr(), segmented=n_seg > 1,
    )
    return states, carry


def tile_launch_shape(n_entries: int, B: int, L: int,
                      sync_len: Optional[int] = None) -> dict:
    """Grid, block and resident blocks per SM of the kernel's launch on
    ``[B, L]`` rows of the current CUDA device (launches nothing)."""
    _, n_seg, _ = tile_segment_plan(L, sync_len)
    shape = scan_states_tile.launch_shape(
        "scan_states_tile_shape", [_I, ctypes.c_longlong, _I, _P, _P, _P],
        n_entries, B * n_seg, int(L % TILE_STEP == 0))
    return {**shape, "segments_per_row": n_seg}
