"""Plain multi-pattern matching: every occurrence of every needle.

The semantics the benchmark holds the system to, written from the
definition alone: a needle matches at every byte offset of a document
where its bytes occur, overlapping occurrences included, never across two
documents.  A record is ``(document, end, pattern)`` with ``end`` the
offset one past the match's last byte and ``pattern`` the needle's index
in the list; records come in ascending ``(document, end, start)`` order,
so at one end the longer needle first.

The scan hashes every window of each needle length with two polynomial
hashes modulo primes below 2**31 (int64 arithmetic never overflows),
looks the joined 62-bit key up among the needles' keys, and compares the
bytes of each window whose key is found with the needle's bytes, so the
answer is exact whatever the hashes do.  It runs on whatever device its
tensors are given, in blocks of rows so that it fits.

``prefix_bytes`` makes the control: a window counts as a match of a
needle when only the needle's first ``prefix_bytes`` bytes agree, with no
exact comparison of the rest.  It breaks the exactness guarantee as a
filter's survivors would, taken for matches.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

P1, P2, BASE = 2_147_483_629, 2_147_483_587, 257
#: window positions hashed at once (bounds the int64 temporaries)
BLOCK_CELLS = 1 << 24


class Needles:
    """The needle list, grouped by length, with each group's sorted keys.

    ``needles``: byte strings, distinct; index ``i`` is pattern ``i``."""

    def __init__(self, needles: Sequence[bytes], device="cpu",
                 prefix_bytes: Optional[int] = None) -> None:
        self.device = torch.device(device)
        self.lens = np.array([len(n) for n in needles], np.int64)
        if self.lens.size and self.lens.min() < 1:
            raise ValueError("an empty needle matches nowhere")
        self.groups: List[dict] = []
        for L in np.unique(self.lens):
            ids = np.flatnonzero(self.lens == L)
            k = int(L) if prefix_bytes is None else min(int(L), prefix_bytes)
            rows = np.frombuffer(b"".join(needles[i][:k] for i in ids),
                                 np.uint8).reshape(len(ids), k)
            if prefix_bytes is not None:
                # one record a window: the lowest id of each prefix
                rows, first = np.unique(rows, axis=0, return_index=True)
                ids = ids[first]
            t = torch.from_numpy(rows.copy()).to(self.device)
            key = _keys(t.long())
            order = torch.argsort(key)
            key = key[order]
            if key.numel() > 1 and bool((key[1:] == key[:-1]).any()):
                raise ValueError("two needles share a hash key")
            self.groups.append({
                "len": int(L), "k": k, "key": key,
                "rows": t[order],
                "ids": torch.from_numpy(ids).to(self.device)[order],
            })


def _keys(rows: torch.Tensor) -> torch.Tensor:
    """The joined key of each row of byte values ``rows [n, k]``."""
    h1 = torch.zeros(rows.shape[0], dtype=torch.int64, device=rows.device)
    h2 = torch.zeros_like(h1)
    for j in range(rows.shape[1]):
        h1 = (h1 * BASE + rows[:, j]) % P1
        h2 = (h2 * BASE + rows[:, j]) % P2
    return (h1 << 31) | h2


def _window_keys(x: torch.Tensor, k: int, n_pos: int) -> torch.Tensor:
    """Key of the ``k``-byte window at each of the first ``n_pos``
    offsets of each row of ``x [R, D]`` (int64 byte values)."""
    h1 = torch.zeros(x.shape[0], n_pos, dtype=torch.int64, device=x.device)
    h2 = torch.zeros_like(h1)
    for j in range(k):
        b = x[:, j : j + n_pos]
        h1 = (h1 * BASE + b) % P1
        h2 = (h2 * BASE + b) % P2
    return (h1 << 31) | h2


def find(docs: np.ndarray, needles: Needles,
         lengths: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
    """Every record of ``needles`` in the documents ``docs [n, D]``
    (uint8; document ``i`` is its first ``lengths[i]`` bytes, all ``D``
    when ``lengths`` is None), as int64 arrays ``doc``, ``pos`` (the end),
    ``start`` and ``pattern`` in ascending ``(doc, end, start)`` order."""
    n, D = docs.shape
    if lengths is None:
        lengths = np.full(n, D, np.int64)
    dev = needles.device
    parts = []
    for g in needles.groups:
        L, k = g["len"], g["k"]
        if D < L:
            continue
        n_pos = D - L + 1
        per = max(1, BLOCK_CELLS // n_pos)
        for r0 in range(0, n, per):
            r1 = min(n, r0 + per)
            x = torch.from_numpy(np.array(docs[r0:r1])).to(dev).long()
            key = _window_keys(x, k, n_pos)
            at = torch.searchsorted(g["key"], key).clamp_(
                max=g["key"].numel() - 1)
            hit = g["key"][at] == key
            rr, pp = torch.nonzero(hit, as_tuple=True)
            if rr.numel() == 0:
                continue
            slot = at[rr, pp]
            win = x[rr[:, None], pp[:, None]
                    + torch.arange(k, device=dev)[None, :]]
            same = (win == g["rows"][slot].long()).all(dim=1)
            rr, pp, slot = rr[same], pp[same], slot[same]
            doc = rr.cpu().numpy().astype(np.int64) + r0
            start = pp.cpu().numpy().astype(np.int64)
            end = start + L
            inside = end <= lengths[doc]
            parts.append((doc[inside], end[inside], start[inside],
                          g["ids"][slot].cpu().numpy()[inside]))
    if not parts:
        z = np.zeros(0, np.int64)
        return {"doc": z, "pos": z, "start": z, "pattern": z}
    doc, end, start, pid = (np.concatenate([p[i] for p in parts])
                            for i in range(4))
    order = np.lexsort((start, end, doc))
    return {"doc": doc[order], "pos": end[order], "start": start[order],
            "pattern": pid[order].astype(np.int64)}


def brute(docs: Sequence[bytes], needles: Sequence[bytes]
          ) -> List[Tuple[int, int, int]]:
    """The same records by ``bytes.find`` over every needle: the slow
    definition the tests hold :func:`find` to."""
    out = []
    for d, doc in enumerate(docs):
        for pid, nd in enumerate(needles):
            at = doc.find(nd)
            while at >= 0:
                out.append((d, at + len(nd), at, pid))
                at = doc.find(nd, at + 1)
    out.sort(key=lambda r: (r[0], r[1], r[2]))
    return [(d, e, p) for d, e, _, p in out]
