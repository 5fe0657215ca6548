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
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .filter_cuda import _check
from .scan_torch import carry_states, scan_states

#: most table entries the kernel stages in shared memory (widened to
#: int32: 16 KiB) — the tile engine's eligibility bound
TILE_MAX_ENTRIES = 4096


def _scan_states_tile_torch(
    table_flat, byte_class, used_bytes, chunks, init_state, n_classes,
    lengths=None,
):
    """Plain PyTorch version of the tile kernel (the dense engine's walk);
    runs on any device."""
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
    _P, _P,  # states, carry
    _P,  # stream
]


def scan_states_tile(
    table_flat: torch.Tensor,  # [S*C] int32 (int16 is widened)
    byte_class: torch.Tensor,  # [256] int32
    used_bytes: torch.Tensor,  # [U] uint8
    chunks: torch.Tensor,  # [B, L] uint8
    init_state: torch.Tensor,  # [B] int32
    n_classes: int,
    lengths: Optional[torch.Tensor] = None,  # [B] int32; None: full rows
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tile-engine DFA scan. Returns ``(states [B, L] int32, carry [B])``.

    ``carry[b]`` is the state after the last *valid* byte
    (``states[b, lengths[b]-1]``; ``init_state[b]`` for empty rows), not
    ``states[:, -1]``, which pad bytes poison for rows shorter than ``L``.

    A CUDA ``chunks`` launches the Hopper kernel (counted in
    ``scan_states_tile.launches``); a CPU one runs the plain version."""
    if not chunks.is_cuda:
        return _scan_states_tile_torch(
            table_flat, byte_class, used_bytes, chunks, init_state,
            n_classes, lengths,
        )
    dev = chunks.device
    B, L = chunks.shape
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
    from ._build import load_library

    fn = load_library("scan_states_tile").scan_states_tile_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    rc = fn(
        table_flat.data_ptr(), n_entries, byte_class.data_ptr(),
        chunks.data_ptr(), init_state.data_ptr(),
        lengths.data_ptr() if lengths is not None else None,
        B, L, n_classes, states.data_ptr(), carry.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"scan_states_tile kernel launch failed: CUDA error {rc}"
        )
    scan_states_tile.launches += 1
    return states, carry


scan_states_tile.launches = 0
