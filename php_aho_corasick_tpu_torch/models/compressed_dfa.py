"""Compressed-row DFA model: the engine of byte-dense signature-scale
needle sets.

Counterpart of the JAX package's ``models/compressed_dfa.py``.  Wraps a
:class:`core.tables.CompressedAutomaton` (dense bank + single-exception
sparse rows), which ``Matcher.finalize`` builds where the dense ``[S, C]``
table would exceed ``ScanConfig.dense_table_max_bytes``.  Its scan costs
3 gathers a byte against the dense table's 1
(``ops/scan_torch.scan_states_compressed``).

It stands in for :class:`DenseDfaModel` where the engines need one
(``scan_host``, ``device_arrays``, ``scan_compact_device``); the
cascade's window verifiers walk its ``device_arrays`` too.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import ScanConfig
from ..core.tables import CompressedAutomaton
from .dense_dfa import device_inputs


class CompressedDfaModel:
    """Device-side compressed automaton + scan methods."""

    def __init__(
        self, auto: CompressedAutomaton, config: ScanConfig,
        device: torch.device,
    ) -> None:
        self.auto = auto
        self.config = config
        self.device = torch.device(device)
        self._dev = None

    # -- host path (small inputs / oracle) -------------------------------

    def scan_host(
        self,
        data: np.ndarray,  # [n] uint8
        init_state: int = 0,
        emit_from: int = 0,
    ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Scalar host scan through the compressed lookup.  Returns
        ``(positions, states, carry_state)``."""
        auto = self.auto
        cls = auto.byte_class[data]
        s = np.int64(init_state)
        pos_out = []
        st_out = []
        one = np.ones(1, dtype=np.int64)
        for t in range(cls.shape[0]):
            s = auto.lookup(s * one, int(cls[t]) * one)[0]
            if t >= emit_from and (
                s >= auto.final_start
                or (auto.dense_final_start <= s < auto.n_dense)
            ):
                pos_out.append(t)
                st_out.append(int(s))
        return (
            np.asarray(pos_out, dtype=np.int64),
            np.asarray(st_out, dtype=np.int32),
            int(s),
        )

    # -- device path ------------------------------------------------------

    @property
    def device_arrays(self):
        """The table on the model's device: ``dense_flat`` (the dense
        bank's rows, flattened), ``meta``, ``exc_target``, ``byte_class``,
        ``used_bytes`` and the two finality bounds as int32 scalars."""
        if self._dev is None:
            auto = self.auto
            # 1-sized placeholders keep the gathers well-formed when every
            # state is dense (tiny automata forced into compressed mode)
            meta = auto.meta if auto.meta.size else np.zeros(1, np.int32)
            tgt = (
                auto.exc_target
                if auto.exc_target.size
                else np.zeros(1, np.int32)
            )

            def put(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(
                    self.device
                )

            def scalar(v):
                return torch.tensor(v, dtype=torch.int32, device=self.device)

            self._dev = {
                "dense_flat": put(auto.dense_table.reshape(-1)),
                "meta": put(meta),
                "exc_target": put(tgt),
                "byte_class": put(auto.byte_class.astype(np.int32)),
                "used_bytes": put(auto.used_bytes),
                "dense_final_start": scalar(auto.dense_final_start),
                "final_start": scalar(auto.final_start),
            }
        return self._dev

    def scan_compact_device(
        self,
        chunks,  # [B, L] uint8 (tensor or numpy)
        lengths,  # [B] int32
        emit_from,  # [B] int32
        init_state: Optional[torch.Tensor],
        capacity: int,
    ):
        """One fixed-capacity scan+compact over the compressed table
        (``ops/scan_torch.scan_and_compact_compressed``)."""
        from ..ops.scan_torch import scan_and_compact_compressed

        dev = self.device_arrays
        chunks, lengths, emit_from, init = device_inputs(
            self.device, chunks, lengths, emit_from, init_state
        )
        return scan_and_compact_compressed(
            dev["dense_flat"],
            dev["meta"],
            dev["exc_target"],
            dev["byte_class"],
            dev["used_bytes"],
            chunks,
            init,
            lengths,
            emit_from,
            dev["dense_final_start"],
            dev["final_start"],
            n_classes=self.auto.n_classes,
            n_dense=self.auto.n_dense,
            capacity=capacity,
        )
