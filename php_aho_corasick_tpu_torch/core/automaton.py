"""Finalize: trie -> compiled dense automaton.

TPU-first re-design of the reference's ``ac_trie_finalize``
(``src/multifast/ahocorasick.c:143-155``):

* failure links computed by **level-order BFS with vectorized numpy steps**
  (O(states) per level) instead of the reference's recursive DFS with
  per-node O(depth^2) suffix probing (``ahocorasick.c:344-396``);
* goto and fail are **precomposed** into one dense table at build time, so
  the device scan never follows failure links;
* match sets are unioned along failure chains exactly like
  ``node_collect_matches`` (``src/multifast/node.c:424-441``) and flattened
  to CSR.

The key identities used (standard Aho-Corasick-as-DFA construction):

  ``delta(s, b) = children[s][b]`` if the edge exists, else
  ``delta(fail(s), b)``  (root's missing edges go to root), and for an edge
  ``s --b--> t`` at depth(s) >= 1: ``fail(t) = delta(fail(s), b)``.

Processing states level by level makes both computable with pure array ops:
when level ``d`` is processed every referenced row belongs to a shallower
level and is already complete.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .tables import CompiledAutomaton, state_dtype
from .trie import TrieBuilder


def compile_trie(
    trie: TrieBuilder,
    pattern_lengths: Sequence[int],
    allow_int16: bool = True,
) -> CompiledAutomaton:
    """Compile a finished trie into a :class:`CompiledAutomaton`.

    ``pattern_lengths[i]`` is the byte length of accepted pattern ``i`` (in
    trie insertion order).
    """
    S = trie.n_states
    own = np.asarray(trie.own, dtype=np.int64)
    depth = np.asarray(trie.depth, dtype=np.int64)
    pat_lens = np.asarray(pattern_lengths, dtype=np.int32)
    assert pat_lens.shape[0] == trie.n_patterns

    # --- byte classes: 0 = byte used by no pattern (always -> root) ---
    used = sorted({b for ch in trie.children for b in ch})
    byte_class = np.zeros(256, dtype=np.int32)
    for i, b in enumerate(used):
        byte_class[b] = i + 1
    C = len(used) + 1

    # --- flat edge arrays (each non-root state has exactly one in-edge) ---
    n_edges = S - 1
    e_src = np.empty(n_edges, dtype=np.int64)
    e_cls = np.empty(n_edges, dtype=np.int64)
    e_dst = np.empty(n_edges, dtype=np.int64)
    k = 0
    for s, ch in enumerate(trie.children):
        for b, t in ch.items():
            e_src[k] = s
            e_cls[k] = byte_class[b]
            e_dst[k] = t
            k += 1
    assert k == n_edges
    # group edges by source depth so levels can be processed with array ops
    order = np.argsort(depth[e_src], kind="stable")
    e_src, e_cls, e_dst = e_src[order], e_cls[order], e_dst[order]
    level_bounds = np.searchsorted(depth[e_src], np.arange(depth.max() + 2))

    # --- level-order closure: table rows + failure links ---
    table = np.zeros((S, C), dtype=np.int64)
    fail = np.zeros(S, dtype=np.int64)
    max_depth = int(depth.max()) if S > 1 else 0
    states_by_level: List[np.ndarray] = [
        np.nonzero(depth == d)[0] for d in range(max_depth + 1)
    ]
    for d in range(max_depth + 1):
        if d > 0:
            lv = states_by_level[d]
            table[lv] = table[fail[lv]]
        lo, hi = level_bounds[d], level_bounds[d + 1]
        src, cls_, dst = e_src[lo:hi], e_cls[lo:hi], e_dst[lo:hi]
        table[src, cls_] = dst
        if d == 0:
            fail[dst] = 0
        else:
            fail[dst] = table[fail[src], cls_]

    # --- match-set union along failure chains (CSR, own-first order) ---
    # lists[s] is a tuple of pattern ids: own pattern (longest) first, then
    # the failure chain's — i.e. decreasing pattern length, reproducing the
    # reference's intra-position ordering.
    lists: List[tuple] = [()] * S
    bfs_order = np.concatenate(states_by_level) if S > 1 else np.array([0])
    for s in bfs_order:
        base = lists[fail[s]] if s != 0 else ()
        lists[s] = ((int(own[s]),) + base) if own[s] >= 0 else base

    counts = np.fromiter((len(l) for l in lists), dtype=np.int64, count=S)

    # --- renumber: non-final states first, finals last (finality becomes a
    # compare on the device: state >= final_start) ---
    is_final = counts > 0
    perm = np.empty(S, dtype=np.int64)  # old id -> new id
    nonfinal_old = np.nonzero(~is_final)[0]
    final_old = np.nonzero(is_final)[0]
    perm[nonfinal_old] = np.arange(nonfinal_old.shape[0])
    perm[final_old] = nonfinal_old.shape[0] + np.arange(final_old.shape[0])
    final_start = int(nonfinal_old.shape[0])
    assert perm[0] == 0  # root is never final (empty patterns rejected)

    inv = np.empty(S, dtype=np.int64)  # new id -> old id
    inv[perm] = np.arange(S)
    table_new = perm[table[inv]]

    emit_start = np.zeros(S + 1, dtype=np.int64)
    np.cumsum(counts[inv], out=emit_start[1:])
    emit_pats = np.fromiter(
        (p for old in inv for p in lists[old]),
        dtype=np.int64,
        count=int(emit_start[-1]),
    )

    dt = state_dtype(S, allow_int16)
    auto = CompiledAutomaton(
        table=table_new.astype(dt),
        byte_class=byte_class,
        emit_start=emit_start.astype(np.int64),
        emit_pats=emit_pats.astype(np.int32),
        pat_lens=pat_lens,
        state_depth=depth[inv].astype(np.int32),
        final_start=final_start,
        max_len=int(trie.max_len),
    )
    return auto


def compile_trie_compressed(
    trie: TrieBuilder,
    pattern_lengths: Sequence[int],
) -> "CompressedAutomaton":
    """Compile a trie into the sparse-row :class:`CompressedAutomaton`.

    Level-order construction that never materializes the dense ``[S, C]``
    table (the point of the format — see tables.CompressedAutomaton).
    Each state is classified as *dense* (full row appended to the bank) or
    *sparse* (one exception over a dense ancestor's row) using the AC
    closure recurrence ``row(s) = row(fail(s)) overlay goto(s)``:

        exceptions(s) = goto(s)  merged-over  (exceptions(fail(s)) if
                        fail(s) is sparse else nothing)

    A state stays sparse iff that merge has <= 1 entry; its ``skip`` is
    the nearest dense state on its failure chain.  All decisions depend
    only on shallower levels, so every step is a vectorized numpy op.
    """
    from .tables import EXC_PACK, CompressedAutomaton

    S = trie.n_states
    own = np.asarray(trie.own, dtype=np.int64)
    depth = np.asarray(trie.depth, dtype=np.int64)
    pat_lens = np.asarray(pattern_lengths, dtype=np.int32)

    used = sorted({b for ch in trie.children for b in ch})
    byte_class = np.zeros(256, dtype=np.int32)
    for i, b in enumerate(used):
        byte_class[b] = i + 1
    C = len(used) + 1

    n_edges = S - 1
    e_src = np.empty(n_edges, dtype=np.int64)
    e_cls = np.empty(n_edges, dtype=np.int64)
    e_dst = np.empty(n_edges, dtype=np.int64)
    k = 0
    for s, ch in enumerate(trie.children):
        for b, t in ch.items():
            e_src[k] = s
            e_cls[k] = byte_class[b]
            e_dst[k] = t
            k += 1
    assert k == n_edges
    order = np.argsort(depth[e_src], kind="stable")
    e_src, e_cls, e_dst = e_src[order], e_cls[order], e_dst[order]
    max_depth = int(depth.max()) if S > 1 else 0
    level_bounds = np.searchsorted(depth[e_src], np.arange(max_depth + 2))

    fail = np.zeros(S, dtype=np.int64)
    counts = np.zeros(S, dtype=np.int64)
    is_dense = np.zeros(S, dtype=bool)
    exc_cls = np.full(S, -1, dtype=np.int64)
    exc_tgt = np.zeros(S, dtype=np.int64)
    skip = np.zeros(S, dtype=np.int64)  # nearest dense failure ancestor
    dense_slot = np.full(S, -1, dtype=np.int64)  # orig id -> bank slot
    bank_rows: List[np.ndarray] = []  # per-level [n_promoted, C] blocks
    n_bank = 0

    def bank() -> np.ndarray:
        # bank rows referenced by any level are complete (shallower levels)
        return (
            np.concatenate(bank_rows, axis=0)
            if len(bank_rows) > 1
            else bank_rows[0]
        )

    def delta(states: np.ndarray, classes: np.ndarray) -> np.ndarray:
        """Vectorized transition over completed (shallower) states."""
        bk = bank()
        row = np.where(is_dense[states], states, skip[states])
        fb = bk[dense_slot[row], classes]
        hit = (~is_dense[states]) & (classes == exc_cls[states])
        return np.where(hit, exc_tgt[states], fb)

    for d in range(max_depth + 1):
        lv = np.nonzero(depth == d)[0]
        lo, hi = level_bounds[d], level_bounds[d + 1]
        src, cls_, dst = e_src[lo:hi], e_cls[lo:hi], e_dst[lo:hi]

        if d == 0:
            # root: always dense
            row = np.zeros((1, C), dtype=np.int64)
            row[0, cls_] = dst
            bank_rows.append(row)
            is_dense[0] = True
            dense_slot[0] = 0
            n_bank = 1
            fail[dst] = 0
            continue

        counts[lv] = (own[lv] >= 0) + counts[fail[lv]]

        # own-edge stats per level state (src is ascending within a level)
        e_lo = np.searchsorted(src, lv)
        e_hi = np.searchsorted(src, lv, side="right")
        n_own = e_hi - e_lo
        safe = np.minimum(e_lo, max(src.shape[0] - 1, 0))
        own1_cls = np.where(n_own == 1, cls_[safe] if src.size else 0, -2)
        own1_tgt = np.where(n_own == 1, dst[safe] if src.size else 0, 0)

        f = fail[lv]
        f_dense = is_dense[f]
        inh_cls = np.where(f_dense, -1, exc_cls[f])
        inh_tgt = exc_tgt[f]
        base_skip = np.where(f_dense, f, skip[f])
        shadow = (n_own == 1) & (inh_cls == own1_cls)
        n_inh = ((inh_cls >= 0) & ~shadow).astype(np.int64)
        n_exc = n_own + n_inh
        promote = n_exc >= 2

        sp = lv[~promote]
        sp_own1 = (n_own[~promote] == 1)
        exc_cls[sp] = np.where(
            sp_own1,
            own1_cls[~promote],
            np.where(n_inh[~promote] > 0, inh_cls[~promote], -1),
        )
        exc_tgt[sp] = np.where(
            sp_own1,
            own1_tgt[~promote],
            np.where(n_inh[~promote] > 0, inh_tgt[~promote], 0),
        )
        skip[sp] = base_skip[~promote]

        pr = lv[promote]
        if pr.size:
            bk = bank()
            rows = bk[dense_slot[base_skip[promote]]].copy()
            # poke the inherited exception first (own edges override)
            has_inh = inh_cls[promote] >= 0
            rows[np.nonzero(has_inh)[0], inh_cls[promote][has_inh]] = (
                inh_tgt[promote][has_inh]
            )
            is_dense[pr] = True  # classify before selecting their edges
            pr_edge = is_dense[src]  # level-d edges out of promoted states
            slot_in_batch = np.searchsorted(pr, src[pr_edge])
            rows[slot_in_batch, cls_[pr_edge]] = dst[pr_edge]
            dense_slot[pr] = n_bank + np.arange(pr.size)
            n_bank += pr.size
            bank_rows.append(rows)

        if src.size:
            fail[dst] = delta(fail[src], cls_)

    if n_bank >= (1 << 31) // EXC_PACK:
        raise ValueError(
            "compressed automaton dense bank too large for meta packing; "
            "this pattern set needs the plain dense table"
        )

    # ---- renumber: [dense nonfinal][dense final][sparse nonfinal][sparse
    # final]; finality needs two compares on device, kind needs one ----
    fin = counts > 0
    dn = np.nonzero(is_dense & ~fin)[0]
    df = np.nonzero(is_dense & fin)[0]
    sn = np.nonzero(~is_dense & ~fin)[0]
    sf = np.nonzero(~is_dense & fin)[0]
    new_order = np.concatenate([dn, df, sn, sf])  # new id -> orig id
    perm = np.empty(S, dtype=np.int64)
    perm[new_order] = np.arange(S)
    D = dn.shape[0] + df.shape[0]
    dense_final_start = int(dn.shape[0])
    final_start = int(D + sn.shape[0])
    assert perm[0] == 0  # root is dense and never final

    bk = bank()
    dense_new = perm[bk[dense_slot[new_order[:D]]]].astype(np.int32)
    sp_orig = new_order[D:]
    skip_new = perm[skip[sp_orig]]
    assert skip_new.size == 0 or skip_new.max() < D
    meta = (skip_new * EXC_PACK + exc_cls[sp_orig] + 1).astype(np.int32)
    tgt_new = np.where(exc_cls[sp_orig] >= 0, perm[exc_tgt[sp_orig]], 0)

    # ---- CSR emit along failure chains (identical order to the dense
    # compiler: own pattern first, then the chain = decreasing length) ----
    emit_start = np.zeros(S + 1, dtype=np.int64)
    counts_new = counts[new_order]
    np.cumsum(counts_new, out=emit_start[1:])
    emit_pats = np.empty(int(emit_start[-1]), dtype=np.int32)
    w = 0
    for ns in np.nonzero(counts_new > 0)[0]:
        s = new_order[ns]
        while True:
            if own[s] >= 0:
                emit_pats[w] = own[s]
                w += 1
            if s == 0:
                break
            s = fail[s]
    assert w == emit_pats.shape[0]

    auto = CompressedAutomaton(
        dense_table=dense_new,
        meta=meta,
        exc_target=tgt_new.astype(np.int32),
        byte_class=byte_class,
        emit_start=emit_start,
        emit_pats=emit_pats,
        pat_lens=pat_lens,
        state_depth=depth[new_order].astype(np.int32),
        dense_final_start=dense_final_start,
        final_start=final_start,
        max_len=int(trie.max_len),
    )
    return auto


def empty_automaton() -> CompiledAutomaton:
    """Automaton of zero patterns (init with empty list is legal in the
    reference, ``tests/test3.phpt:12``): single root state, never matches."""
    return CompiledAutomaton(
        table=np.zeros((1, 1), dtype=np.int16),
        byte_class=np.zeros(256, dtype=np.int32),
        emit_start=np.zeros(2, dtype=np.int64),
        emit_pats=np.zeros(0, dtype=np.int32),
        pat_lens=np.zeros(0, dtype=np.int32),
        state_depth=np.zeros(1, dtype=np.int32),
        final_start=1,
        max_len=0,
    )
