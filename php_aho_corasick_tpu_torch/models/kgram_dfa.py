"""k-gram super-transition DFA: one gather advances k bytes.

Counterpart of the JAX package's ``models/kgram_dfa.py``.  The table
precomposes k DFA steps,

    ``ktable[s, code(c_0..c_{k-1})] = end_state | (mid_final_flag << 30)``

where the mid-final flag records that a position strictly inside the
k-byte cell reached a final state; the end state's finality is the usual
``state >= final_start`` compare.  Flagged cells are re-walked on the
host through the 1-gram table for exact positions
(``ops/matches.expand_matches_kgram_arrays``): work proportional to the
match density, not the corpus.

The table holds ``S * C^k`` entries, so k is picked against a byte budget
(``ScanConfig.kgram_budget_bytes``).  Tables of fewer than 2^15 states
are stored as int16 (the flag in the sign bit).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import ScanConfig
from ..core.tables import CompiledAutomaton
from ..ops.scan_torch import KGRAM_MID_FLAG
from .dense_dfa import device_inputs

MAX_K = 8


def pick_k(auto: CompiledAutomaton, budget_bytes: int) -> int:
    """Largest power-of-two k with S * C^k int32 entries within budget.

    k is restricted to {1, 2, 4, 8} so row padding (multiples of 128)
    always divides into whole cells.
    """
    S, C = auto.n_states, auto.n_classes
    if S >= KGRAM_MID_FLAG:  # states must fit below the flag bit
        return 1
    k = 1
    while (
        k * 2 <= MAX_K
        and S * (C ** (k * 2)) * 4 <= budget_bytes
        and S * (C ** (k * 2)) < 2**31  # flat index must fit int32
    ):
        k *= 2
    return k


def build_kgram_table(auto: CompiledAutomaton, k: int) -> np.ndarray:
    """Compose the 1-gram table k times into packed entries ``[S * C^k]``.

    Composition identity: for the (j+1)-gram ending in class c,
    ``next = table1[next_j, c]`` and the new mid set = mids of the j-gram
    plus the j-gram's end position — so ``flag_{j+1} = flag_j | final(next_j)``
    (independent of c; broadcast over the last digit).
    """
    assert k >= 1
    S, C = auto.table.shape
    table1 = np.ascontiguousarray(auto.table).astype(np.int32)
    fs = auto.final_start
    cur_next = table1  # [S, C^j]
    cur_flag = np.zeros((S, C), dtype=bool)
    for _ in range(k - 1):
        nxt = table1[cur_next]  # [S, C^j, C]
        flag = cur_flag[..., None] | (cur_next >= fs)[..., None]
        cur_next = nxt.reshape(S, -1)
        cur_flag = np.broadcast_to(flag, nxt.shape).reshape(S, -1)
    entries = cur_next.astype(np.int32)
    np.bitwise_or(entries, np.where(cur_flag, KGRAM_MID_FLAG, 0), out=entries)
    return entries.reshape(-1)


class KgramDfaModel:
    """Device-side k-gram automaton + scan method."""

    def __init__(
        self, auto: CompiledAutomaton, config: ScanConfig,
        device: torch.device, k: Optional[int] = None,
    ) -> None:
        self.auto = auto
        self.config = config
        self.device = torch.device(device)
        self.k = k if k is not None else pick_k(auto, config.kgram_budget_bytes)
        self._ktable_host: Optional[np.ndarray] = None
        self._dev = None

    @property
    def ktable_host(self) -> np.ndarray:
        """The packed table, int16 (state in 15 bits, flag in the sign
        bit) below 2^15 states with ``allow_int16_states``, else int32."""
        if self._ktable_host is None:
            from .. import native

            if self.config.prefer_native_builder and native.available():
                kt = native.kgram_build(self.auto, self.k)
            else:
                kt = build_kgram_table(self.auto, self.k)
            if self.auto.n_states < (1 << 15) and self.config.allow_int16_states:
                kt = (
                    (kt & 0x7FFF) | (((kt >> 30) & 1) << 15)
                ).astype(np.uint16).view(np.int16)
            self._ktable_host = kt
        return self._ktable_host

    @property
    def device_arrays(self):
        if self._dev is None:
            auto = self.auto
            self._dev = {
                "ktable": torch.from_numpy(self.ktable_host).to(self.device),
                "byte_class": torch.from_numpy(
                    auto.byte_class.astype(np.int32)
                ).to(self.device),
                "used_bytes": torch.from_numpy(auto.used_bytes).to(
                    self.device
                ),
                "final_start": torch.tensor(
                    auto.final_start, dtype=torch.int32, device=self.device
                ),
            }
        return self._dev

    def scan_compact_device(
        self,
        chunks,  # [B, L] uint8, L % k == 0 (pack pads)
        lengths,
        emit_from,
        init_state: Optional[torch.Tensor],
        capacity: int,
    ):
        """One fixed-capacity k-gram scan + cell compaction
        (``ops/scan_torch.scan_and_compact_kgram``)."""
        from ..ops.scan_torch import scan_and_compact_kgram

        dev = self.device_arrays
        chunks, lengths, emit_from, init = device_inputs(
            self.device, chunks, lengths, emit_from, init_state
        )
        return scan_and_compact_kgram(
            dev["ktable"],
            dev["byte_class"],
            dev["used_bytes"],
            chunks,
            init,
            lengths,
            emit_from,
            dev["final_start"],
            n_classes=self.auto.n_classes,
            k=self.k,
            capacity=capacity,
        )
