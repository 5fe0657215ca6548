"""Peaks of the card and the least time of a stage's work.

The arithmetic of ``chip_smoke.py`` (``bound_of``, the peaks), frozen here
so that the yardstick does not move with the program.  Work is reckoned
from the shapes and the plan of the stage, never from the kernels that
implement it, so a stage reads the same work whatever computes it.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth, bytes a second
HBM_BYTES_PER_S = 3.35e12
#: 32-bit integer operations a second: 132 SMs x 64 int32 lanes x 1.98
#: GHz boost clock (NVIDIA Hopper architecture white paper)
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def bound_of(n_bytes: float, ops: float) -> dict:
    """The larger of the memory floor and the operations floor."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = ops / INT32_OPS_PER_S
    return {"seconds": max(t_bytes, t_ops),
            "by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "ops": ops}


def sampled_filter_work(rows: int, row_len: int, q: int, stride: int,
                        bloom_bytes: int, probe_ops: int) -> dict:
    """Least work of the sampled q-gram filter over a ``[rows, row_len]``
    byte corpus: one grid cell every ``stride`` bytes; at each cell the
    q-gram's code (``4 ceil(q/4) + 6`` operations: a dp4a a byte plane of
    each 4-byte word, and the joins, as ``chip_smoke.py`` counts) and one
    probe of the bloom (``probe_ops`` operations: 12 for a banked bloom
    word, 6 for a positional bloom bit).  Bytes: the corpus read once,
    and the bloom's words once, but no more of them than probes (4 bytes
    a probe).  The further probes of cells that pass the first, and the
    survivors' refinement, depend on the data and are left out, so this
    stays a floor."""
    cells = rows * (row_len // stride)
    ops = cells * (4 * -(-q // 4) + 6) + probe_ops * cells
    n_bytes = rows * row_len + min(bloom_bytes, 4 * cells)
    return bound_of(n_bytes, ops)
