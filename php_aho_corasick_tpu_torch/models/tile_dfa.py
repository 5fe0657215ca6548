"""Tile DFA model — the shared-memory scan for small automata.

Counterpart of the JAX package's ``models/tile_dfa.py``.  Wraps
ops/scan_cuda.scan_states_tile: when ``S * C`` fits in shared memory, each
row walks its bytes through the staged table (``csrc/scan_states_tile.cu``
on the card).  Match compaction is the dense engine's, so output
semantics are identical to the dense DFA.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ScanConfig
from ..core.tables import CompiledAutomaton
from ..ops.scan_cuda import TILE_MAX_ENTRIES as TILE_TABLE_MAX
from ..ops.scan_cuda import scan_states_tile
from ..ops.scan_torch import compact_final_states
from .dense_dfa import automaton_arrays, device_inputs


def tile_eligible(auto: CompiledAutomaton) -> bool:
    return auto.n_states * auto.n_classes <= TILE_TABLE_MAX


class TileDfaModel:
    def __init__(
        self, auto: CompiledAutomaton, config: ScanConfig,
        device: torch.device,
    ) -> None:
        assert tile_eligible(auto)
        self.auto = auto
        self.config = config
        self.device = torch.device(device)
        # the kernel takes an int32 table: widened once here, not per scan
        self.device_arrays = automaton_arrays(auto, self.device, np.int32)

    def scan_compact_device(
        self,
        chunks,
        lengths,
        emit_from,
        init_state,
        capacity: int,
    ):
        """One fixed-capacity scan+compact: the tile kernel's states
        compacted as the dense engine's (see ops.scan_torch)."""
        dev = self.device_arrays
        chunks, lengths, emit_from, init = device_inputs(
            self.device, chunks, lengths, emit_from, init_state
        )
        states, carry = scan_states_tile(
            dev["table_flat"],
            dev["byte_class"],
            dev["used_bytes"],
            chunks,
            init,
            n_classes=self.auto.n_classes,
            lengths=lengths,
            # an Aho-Corasick DFA: its rows may be walked in segments
            sync_len=self.auto.max_len,
        )
        idx, sts, n = compact_final_states(
            states, lengths, emit_from, dev["final_start"], capacity
        )
        return idx, sts, n, carry
