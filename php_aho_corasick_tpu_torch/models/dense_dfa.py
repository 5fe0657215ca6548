"""Dense byte-class DFA: the compiled automaton's device arrays.

Counterpart of the JAX package's ``models/dense_dfa.py``.  In this port it
holds only what the cascade's window verifier shares: the flattened
``[S, C]`` transition table and the finality threshold, on ``device``.
The dense scan engine itself is not ported yet (ROADMAP queue 1 item 5).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ScanConfig
from ..core.tables import CompiledAutomaton


class DenseDfaModel:
    """Device-side automaton arrays."""

    def __init__(
        self, auto: CompiledAutomaton, config: ScanConfig,
        device: torch.device,
    ) -> None:
        self.auto = auto
        self.config = config
        self.device = torch.device(device)
        self._dev = None  # lazily-created device arrays

    @property
    def device_arrays(self):
        if self._dev is None:
            auto = self.auto
            table = np.ascontiguousarray(auto.table).reshape(-1)
            self._dev = {
                "table_flat": torch.from_numpy(table).to(self.device),
                "final_start": torch.tensor(
                    auto.final_start, dtype=torch.int32, device=self.device
                ),
            }
        return self._dev
