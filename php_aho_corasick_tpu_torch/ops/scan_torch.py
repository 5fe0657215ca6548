"""Device scan primitives in PyTorch: byte classification and the
fixed-capacity compaction every cascade stage ends with.

Counterpart of the JAX package's ``ops/scan_jax.py`` (only the pieces the
resident-corpus records path runs).  Everything here is plain tensor code
that stays on the tensors' device and never synchronises with the host:
compaction uses ``torch.nonzero_static``, whose output shape is fixed by
``size`` (plain ``torch.nonzero`` has to ask the device for its count).
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
