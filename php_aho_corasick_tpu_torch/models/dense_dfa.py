"""Dense byte-class DFA — the exact fallback engine.

Counterpart of the JAX package's ``models/dense_dfa.py``.  Wraps a
:class:`CompiledAutomaton` with its device-resident arrays (the flattened
``[S, C]`` transition table, the 256-entry byte-class map, the used
bytes and the finality threshold, on ``device``; the cascade's window
verifier shares the table) and the scan entry points.

A host (numpy) scalar scanner is included as the small-input fast path
(device dispatch overhead dominates below a few KiB) and doubles as an
in-process oracle for the device scans.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import ScanConfig
from ..core.tables import CompiledAutomaton


class DenseDfaModel:
    """Device-side automaton + scan methods."""

    def __init__(
        self, auto: CompiledAutomaton, config: ScanConfig,
        device: torch.device,
    ) -> None:
        self.auto = auto
        self.config = config
        self.device = torch.device(device)
        self._dev = None  # lazily-created device arrays

    # -- host fast path -------------------------------------------------

    def scan_host(
        self,
        data: np.ndarray,  # [n] uint8
        init_state: int = 0,
        emit_from: int = 0,
    ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Scalar reference scan. Returns (positions, states, carry_state).

        ``positions[i]`` is the in-buffer index whose consumption reached a
        final state; emission starts at ``emit_from``.
        """
        auto = self.auto
        table = auto.table
        cls = auto.byte_class[data]
        s = init_state
        fs = auto.final_start
        pos_out = []
        st_out = []
        for t in range(cls.shape[0]):
            s = int(table[s, cls[t]])
            if s >= fs and t >= emit_from:
                pos_out.append(t)
                st_out.append(s)
        return (
            np.asarray(pos_out, dtype=np.int64),
            np.asarray(st_out, dtype=np.int32),
            s,
        )

    # -- device path ----------------------------------------------------

    @property
    def device_arrays(self):
        if self._dev is None:
            self._dev = automaton_arrays(self.auto, self.device)
        return self._dev

    def scan_compact_device(
        self,
        chunks,  # [B, L] uint8 (tensor or numpy)
        lengths,  # [B] int32
        emit_from,  # [B] int32
        init_state: Optional[torch.Tensor],  # [B] int32 or None (root)
        capacity: int,
    ):
        """One fixed-capacity scan+compact (see ops.scan_torch)."""
        from ..ops.scan_torch import scan_and_compact

        dev = self.device_arrays
        chunks, lengths, emit_from, init = device_inputs(
            self.device, chunks, lengths, emit_from, init_state
        )
        return scan_and_compact(
            dev["table_flat"],
            dev["byte_class"],
            dev["used_bytes"],
            chunks,
            init,
            lengths,
            emit_from,
            dev["final_start"],
            n_classes=self.auto.n_classes,
            capacity=capacity,
        )


def automaton_arrays(auto: CompiledAutomaton, device, table_dtype=None):
    """The automaton's scan arrays on ``device``: ``table_flat`` (the
    ``[S, C]`` table flattened, in ``table_dtype`` when given),
    ``byte_class`` (int32), ``used_bytes`` and ``final_start``."""
    table = np.ascontiguousarray(auto.table).reshape(-1)
    if table_dtype is not None:
        table = table.astype(table_dtype)
    return {
        "table_flat": torch.from_numpy(table).to(device),
        "byte_class": torch.from_numpy(
            auto.byte_class.astype(np.int32)
        ).to(device),
        "used_bytes": torch.from_numpy(auto.used_bytes).to(device),
        "final_start": torch.tensor(
            auto.final_start, dtype=torch.int32, device=device
        ),
    }


def device_inputs(device, chunks, lengths, emit_from, init_state):
    """Scan inputs as tensors on ``device`` (no copy for tensors already
    there); ``init_state`` None starts every row at the root."""
    chunks, lengths, emit_from = (
        torch.as_tensor(x, device=device)
        for x in (chunks, lengths, emit_from)
    )
    if init_state is None:
        init = torch.zeros(
            (chunks.shape[0],), dtype=torch.int32, device=device
        )
    else:
        init = torch.as_tensor(init_state, dtype=torch.int32, device=device)
    return chunks, lengths, emit_from, init
