"""Data-parallel sharded scans over a :class:`~.mesh.DataMesh`.

Counterpart of the JAX package's ``parallel/shard_scan.py``, whose
``shard_map`` bodies run one chip's scan on its rows.  Here each function
loops over this process's shards: it runs the port's single-device
function on shard ``s``'s row block under ``torch.cuda.device(mesh[s])``
(on that device's current stream, so every shard is enqueued before any
host fetch), adds ``s * local_cells`` to every compacted index below
``INT32_MAX``, and gathers:

* ``counts [n_shards]`` int32, every shard's true count, and ``gstats =
  [sum, max]`` int32 (the JAX package's ``psum`` and ``pmax``): the
  capacity-retry decision is one fetch of the worst occupancy;
* the per-shard buffers, stacked shard-major into ``[n_shards, cap]``.

All of them land on the mesh's first device, gathered by non-blocking
copies with no host sync.  Across processes (``collect=True``), counts
and buffers are placed in their global shard slots of a zero tensor and
summed with ``torch.distributed.all_reduce``, the JAX package's psum of a
slot-masked contribution, so every process holds every shard's results.

Shard-major concatenation keeps global scan order: rows are packed
document-major and shards are contiguous row blocks.  Rows carry their
left overlap (``ops/matches.pack_documents``), so no shard needs its
neighbour's bytes.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import torch

from ..ops.scan_torch import INT32_MAX
from ..utils.profiling import span
from .mesh import DataMesh, process_count, replicated, row_sharding


def per_shard_capacity(
    global_est: int, n_shards: int, floor: int = 256
) -> int:
    """Per-shard buffer capacity from a GLOBAL hit estimate: the shard
    mean plus a 4-sigma Poisson imbalance margin (rows are sharded by
    contiguous blocks, so per-shard counts concentrate around
    ``global/n``).

    The rule is the JAX package's, verbatim: the window verifiers walk
    their full static capacity, so a shard sized for the global count
    does ``n_shards`` x too much verify work, and throughput falls as
    shards are added (the JAX package measured this on its 8-device CPU
    mesh, ``docs/PERF_NOTES.md``).  The ``floor`` is the fixed term:
    shards stop helping once ``global/n`` drops under it."""
    mean = max(int(global_est), 1) / max(n_shards, 1)
    return max(floor, int(mean + 4.0 * mean**0.5 + 8))


def _on(device: torch.device):
    """``torch.cuda.device(device)`` for a card, nothing for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _shards(mesh: DataMesh, x) -> List[torch.Tensor]:
    """Per-shard row blocks: ``x`` as given when it is already a list of
    them, else split by :func:`~.mesh.row_sharding`."""
    if isinstance(x, (list, tuple)):
        if len(x) != mesh.n_local:
            raise ValueError(
                f"{len(x)} row blocks for {mesh.n_local} local shards"
            )
        return list(x)
    return row_sharding(mesh, x)


def _arrays(mesh: DataMesh, arrays) -> List[dict]:
    """Per-shard automaton arrays: ``arrays`` as given when it is already
    a list of dicts, else :func:`~.mesh.replicated`."""
    if isinstance(arrays, (list, tuple)):
        return list(arrays)
    return replicated(mesh, arrays)


def _globalize(idx: torch.Tensor, shard: int, local_cells: int):
    """Shard-local compacted indices to global ones (padding kept)."""
    return torch.where(idx < INT32_MAX, idx + shard * local_cells, idx)


def _collect(mesh: DataMesh, local: torch.Tensor) -> torch.Tensor:
    """``[n_local, ...]`` -> ``[n_shards, ...]`` with every process's
    shards: each process fills its own slots of a zero tensor and the
    group sums them."""
    full = torch.zeros(
        (mesh.n_shards,) + tuple(local.shape[1:]), dtype=local.dtype,
        device=local.device,
    )
    full[mesh.first_shard : mesh.first_shard + mesh.n_local] = local
    if process_count() > 1:
        import torch.distributed as dist

        dist.all_reduce(full)
    return full


def _globalize_counts(mesh: DataMesh, ns: Sequence[torch.Tensor],
                      collect: bool = False):
    """``(counts [n_shards] int32, gstats [2] int32 = [sum, max])`` of the
    shards' 0-d counts, on the mesh's first device."""
    home = mesh.home
    with span("gather", card=home, shards=len(ns)):
        local = torch.stack([
            n.reshape(()).to(home, torch.int32, non_blocking=True)
            for n in ns
        ])
        counts = _collect(mesh, local) if collect else local
        gstats = torch.stack([counts.sum(), counts.max()]).to(torch.int32)
    return counts, gstats


def _maybe_collect(mesh: DataMesh, bufs: Sequence[torch.Tensor],
                   collect: bool = False) -> torch.Tensor:
    """The shards' ``[cap]`` buffers as one ``[n_shards, cap]`` tensor on
    the mesh's first device (every process's shards with ``collect``)."""
    home = mesh.home
    with span("gather", card=home, shards=len(bufs)):
        local = torch.stack([b.to(home, non_blocking=True) for b in bufs])
        return _collect(mesh, local) if collect else local


def _scan_shards(mesh, arrays, chunks, init_state, lengths, emit_from,
                 scan, cells_per_row, collect):
    """Shared body of the dense, tile, compressed and k-gram scans:
    ``scan(arrays, chunks, init, lengths, emit_from) -> (idx, aux, n,
    carry)`` per shard, then globalized as the module docstring says."""
    arrays = _arrays(mesh, arrays)
    chunks, lengths, emit_from = (
        _shards(mesh, x) for x in (chunks, lengths, emit_from)
    )
    if init_state is None:
        init_state = [torch.zeros(c.shape[0], dtype=torch.int32,
                                  device=c.device) for c in chunks]
    else:
        init_state = _shards(mesh, init_state)
    idx_l, aux_l, n_l, carry_l = [], [], [], []
    for i, (s, dev) in enumerate(zip(mesh.shard_ids, mesh.devices)):
        with _on(dev):
            idx, aux, n, carry = scan(
                arrays[i], chunks[i], init_state[i], lengths[i], emit_from[i]
            )
            B, L = chunks[i].shape
            idx_l.append(_globalize(idx, s, B * cells_per_row(L)))
        aux_l.append(aux)
        n_l.append(n)
        carry_l.append(carry)
    counts, gstats = _globalize_counts(mesh, n_l, collect)
    carry = torch.cat([c.to(mesh.home, non_blocking=True) for c in carry_l])
    return (
        _maybe_collect(mesh, idx_l, collect),
        _maybe_collect(mesh, aux_l, collect),
        counts,
        gstats,
        carry,
    )


def sharded_scan_compact(
    mesh: DataMesh,
    dev_arrays,
    chunks,
    init_state,
    lengths,
    emit_from,
    n_classes: int,
    capacity: int,
    collect: bool = False,
):
    """The compacted 1-gram scan (``ops/scan_torch.scan_and_compact``) over
    the mesh.

    ``dev_arrays``: the automaton's ``table_flat``, ``byte_class``,
    ``used_bytes`` and ``final_start`` (one dict, or one per shard from
    :func:`~.mesh.replicated`); the row inputs are per-shard lists or
    whole arrays (split here); ``init_state`` None starts at the root.
    Returns ``(idx [n_shards, capacity], states [n_shards, capacity],
    counts [n_shards], gstats [2] = [sum, max], carry [B])``: ``idx``
    entries are global ``row * L + t`` cell indices, ascending within
    each shard."""
    from ..ops.scan_torch import scan_and_compact

    def scan(a, ch, ini, ln, ef):
        return scan_and_compact(
            a["table_flat"], a["byte_class"], a["used_bytes"], ch, ini, ln,
            ef, a["final_start"], n_classes=n_classes, capacity=capacity,
        )

    return _scan_shards(mesh, dev_arrays, chunks, init_state, lengths,
                        emit_from, scan, lambda L: L, collect)


def sharded_scan_compact_tile(
    mesh: DataMesh,
    dev_arrays,
    chunks,
    init_state,
    lengths,
    emit_from,
    n_classes: int,
    capacity: int,
    collect: bool = False,
    sync_len: Optional[int] = None,
):
    """Tile-engine edition of :func:`sharded_scan_compact` (same
    contract): ``scan_states_tile`` per shard, its kernel on a card and
    its plain version on the CPU, then the dense engine's compaction.
    ``sync_len`` as in ``ops/scan_cuda.scan_states_tile`` (an
    Aho-Corasick table's longest pattern; the states are the same)."""
    from ..ops.scan_cuda import scan_states_tile
    from ..ops.scan_torch import compact_final_states

    def scan(a, ch, ini, ln, ef):
        states, carry = scan_states_tile(
            a["table_flat"], a["byte_class"], a["used_bytes"], ch, ini,
            n_classes=n_classes, lengths=ln, sync_len=sync_len,
        )
        idx, sts, n = compact_final_states(
            states, ln, ef, a["final_start"], capacity
        )
        return idx, sts, n, carry

    return _scan_shards(mesh, dev_arrays, chunks, init_state, lengths,
                        emit_from, scan, lambda L: L, collect)


def sharded_scan_compact_compressed(
    mesh: DataMesh,
    dev_arrays,
    chunks,
    init_state,
    lengths,
    emit_from,
    n_classes: int,
    n_dense: int,
    capacity: int,
    collect: bool = False,
):
    """The compacted compressed-table scan over the mesh (byte-dense
    signature-scale sets, ``core/tables.CompressedAutomaton``); outputs as
    :func:`sharded_scan_compact`.  ``dev_arrays`` is the compressed
    model's ``device_arrays``: the dense bank and exception arrays, held
    once per distinct device."""
    from ..ops.scan_torch import scan_and_compact_compressed

    def scan(a, ch, ini, ln, ef):
        return scan_and_compact_compressed(
            a["dense_flat"], a["meta"], a["exc_target"], a["byte_class"],
            a["used_bytes"], ch, ini, ln, ef, a["dense_final_start"],
            a["final_start"], n_classes=n_classes, n_dense=n_dense,
            capacity=capacity,
        )

    return _scan_shards(mesh, dev_arrays, chunks, init_state, lengths,
                        emit_from, scan, lambda L: L, collect)


def sharded_scan_compact_kgram(
    mesh: DataMesh,
    dev_arrays,
    chunks,
    init_state,
    lengths,
    emit_from,
    n_classes: int,
    k: int,
    capacity: int,
    collect: bool = False,
):
    """Sharded k-gram scan (``models/kgram_dfa.py``): ``(cell_idx
    [n_shards, cap], prev_state [n_shards, cap], counts, gstats, carry)``
    with global ``row * (L // k) + cell`` indices."""
    from ..ops.scan_torch import scan_and_compact_kgram

    def scan(a, ch, ini, ln, ef):
        return scan_and_compact_kgram(
            a["ktable"], a["byte_class"], a["used_bytes"], ch, ini, ln, ef,
            a["final_start"], n_classes=n_classes, k=k, capacity=capacity,
        )

    return _scan_shards(mesh, dev_arrays, chunks, init_state, lengths,
                        emit_from, scan, lambda L: L // k, collect)


def _grid_cells(rows: int, L: int, stride: int) -> int:
    """Sampled-filter grid cells of a shard: rows x ceil(L / stride)."""
    return rows * (-(-L // stride))


def _cascade_shards(mesh, cascade_model, row_inputs):
    """``(shard id, model on its device, its row blocks)`` per shard."""
    blocks = [_shards(mesh, x) if x is not None else [None] * mesh.n_local
              for x in row_inputs]
    for i, (s, dev) in enumerate(zip(mesh.shard_ids, mesh.devices)):
        yield s, dev, cascade_model.on_device(dev), [b[i] for b in blocks]


def sharded_filter_candidates(
    mesh: DataMesh,
    cascade_model,
    chunks,
    lengths,
    emit_from,
    capacity: int,
    collect: bool = False,
):
    """Sharded anchored candidate filter (``CascadeModel.scan_candidates``
    per shard, its stages probed through ``bloom_hit``).  Returns ``(idx
    [n_shards, cap], counts [n_shards], gstats [2])`` with global
    flattened start indices.  ``emit_from`` is not read: ownership is
    checked by the host verify, as on one device."""
    idx_l, n_l = [], []
    for s, dev, cm, (ch, ln) in _cascade_shards(
        mesh, cascade_model, (chunks, lengths)
    ):
        with _on(dev):
            idx, n = cm.scan_candidates(ch, ln, capacity)
            idx_l.append(_globalize(idx, s, ch.shape[0] * ch.shape[1]))
        n_l.append(n)
    counts, gstats = _globalize_counts(mesh, n_l, collect)
    return _maybe_collect(mesh, idx_l, collect), counts, gstats


def sharded_filter_hits_sampled(
    mesh: DataMesh,
    cascade_model,
    chunks,
    lengths,
    capacity: int,
    collect: bool = False,
):
    """Sharded flat take filter (``ops/filter_torch.filter_hits_sampled``).
    Returns ``(grid_idx [n_shards, cap], long_word, short_word, counts
    [n_shards], gstats [2])`` with global grid indices (host expansion:
    ``CascadeModel.expand_hits``)."""
    from ..ops.filter_torch import filter_hits_sampled

    p = cascade_model.plan
    idx_l, lw_l, sw_l, n_l = [], [], [], []
    for s, dev, cm, (ch, ln) in _cascade_shards(
        mesh, cascade_model, (chunks, lengths)
    ):
        d = cm.device_arrays
        with _on(dev):
            idx, lw, sw, n = filter_hits_sampled(
                d["sampled_words"], ch, ln, d["min_long_len"], q=p.q,
                stride=p.stride, log2_words=p.log2_words,
                salts=p.sampled_salts, shorts=p.shorts, capacity=capacity,
            )
            idx_l.append(_globalize(
                idx, s, _grid_cells(ch.shape[0], ch.shape[1], p.stride)
            ))
        lw_l.append(lw)
        sw_l.append(sw)
        n_l.append(n)
    counts, gstats = _globalize_counts(mesh, n_l, collect)
    return (
        _maybe_collect(mesh, idx_l, collect),
        _maybe_collect(mesh, lw_l, collect),
        _maybe_collect(mesh, sw_l, collect),
        counts,
        gstats,
    )


def sharded_sampled_verified(
    mesh: DataMesh,
    cascade_model,
    chunks,
    lengths,
    cap_hits: int,
    cap_flagged: int,
    collect: bool = False,
    phase_g=None,
):
    """Sharded sampled filter + flagged-window verify chain.  Returns
    ``(cells [n_shards, cap_flagged] global grid ids, n_flagged
    [n_shards], gstats_hits [2], gstats_flagged [2], gstats_coarse
    [2])``.  The bank-bloom route runs ``CascadeModel.launch_device`` per
    shard (the fused kernel, or ``bloom_word_vmem`` through the per-row
    filter; ``phase_g``: per-shard cached word phases, or None); the take
    route runs the flat take filter and the per-class window walk, and
    reports zeroed coarse stats (it has no slot capacity), as the JAX
    package does."""
    from ..ops.filter_torch import filter_hits_sampled

    p = cascade_model.plan
    vmem = cascade_model.bloom_impl() == "pallas_vmem"
    cells_l, n_l, nf_l, nc_l = [], [], [], []
    for s, dev, cm, (ch, ln, ph) in _cascade_shards(
        mesh, cascade_model, (chunks, lengths, phase_g)
    ):
        with _on(dev):
            if vmem:
                cells, n, nf, nc = cm.launch_device(
                    ch, ln, cap_hits, cap_flagged, phase_g=ph
                )
            else:
                d = cm.device_arrays
                idx, _lw, _sw, n = filter_hits_sampled(
                    d["sampled_words"], ch, ln, d["min_long_len"], q=p.q,
                    stride=p.stride, log2_words=p.log2_words,
                    salts=p.sampled_salts, shorts=p.shorts,
                    capacity=cap_hits,
                )
                cells, nf = cm.verify_hits(ch, ln, idx, cap_hits,
                                           cap_flagged, kgram=False)
                nc = torch.zeros_like(n)
            cells_l.append(_globalize(
                cells, s, _grid_cells(ch.shape[0], ch.shape[1], p.stride)
            ))
        n_l.append(n)
        nf_l.append(nf)
        nc_l.append(nc)
    _, gstats_hits = _globalize_counts(mesh, n_l, collect)
    nfs, gstats_flagged = _globalize_counts(mesh, nf_l, collect)
    _, gstats_coarse = _globalize_counts(mesh, nc_l, collect)
    return (
        _maybe_collect(mesh, cells_l, collect),
        nfs,
        gstats_hits,
        gstats_flagged,
        gstats_coarse,
    )


def sharded_sampled_records(
    mesh: DataMesh,
    cascade_model,
    chunks,
    lengths,
    emit_from,
    cap_hits: int,
    cap_rec: int,
    collect: bool = False,
    phase_g=None,
):
    """Sharded sampled filter + match-record verify chain: the sharded
    ``CascadeModel.launch_device_records``, run per shard.  Its filter is
    the single-device chain's: the fused kernel (bank bloom, stride a
    multiple of 4), the per-row filter on ``bloom_word_vmem``, the
    grouped take filter (on ``grouped_take_extract`` and
    ``grouped_take_refine``) where the cell-alignment gate holds, else
    the flat take filter (zeroed coarse counts).  ``phase_g``: per-shard
    cached word phases of the fused filter, or None.  Returns ``(rec_cell [n_shards, cap_rec]
    global grid ids, rec_pack [n_shards, cap_rec], n_recs [n_shards],
    gstats_hits [2], gstats_rec [2], gstats_coarse [2])``; callers gate
    on ``cascade_model.records_ok``."""
    stride = cascade_model.plan.stride
    rc_l, rp_l, n_l, nr_l, nc_l = [], [], [], [], []
    for s, dev, cm, (ch, ln, ef, ph) in _cascade_shards(
        mesh, cascade_model, (chunks, lengths, emit_from, phase_g)
    ):
        with _on(dev):
            rc, rp, n, nr, nc = cm.launch_device_records(
                ch, ln, ef, cap_hits, cap_rec, phase_g=ph
            )
            rc_l.append(_globalize(
                rc, s, _grid_cells(ch.shape[0], ch.shape[1], stride)
            ))
        rp_l.append(rp)
        n_l.append(n)
        nr_l.append(nr)
        nc_l.append(nc)
    nrs, gstats_rec = _globalize_counts(mesh, nr_l, collect)
    _, gstats_hits = _globalize_counts(mesh, n_l, collect)
    _, gstats_coarse = _globalize_counts(mesh, nc_l, collect)
    return (
        _maybe_collect(mesh, rc_l, collect),
        _maybe_collect(mesh, rp_l, collect),
        nrs,
        gstats_hits,
        gstats_rec,
        gstats_coarse,
    )
