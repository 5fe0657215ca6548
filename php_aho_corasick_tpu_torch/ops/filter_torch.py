"""Gram-filter cascade in PyTorch: the sampled records chain (filter ->
slot compaction -> window verify) and the anchored candidate filter.

Counterpart of the JAX package's ``ops/filter_jax.py``.  **Sampled**: any
occurrence of a pattern of length >= ``min_long`` covers exactly one
point of a ``stride`` lattice, so a positional-alignment bloom (bit ``j``
set <=> some long pattern has this q-gram at offset ``j``) is probed only
at grid points.  Where the planner built a bank bloom, and the stride is
a multiple of 4 dividing the row length, survivors are rank-extracted by
the fused kernel (``ops/filter_cuda.fused_sampled_extract``); else the
per-row filter probes every cell's code through
``ops/filter_cuda.bloom_word_vmem`` and rank-extracts per 128-lane row.
Without a bank bloom the take filters probe the positional bloom itself
by gathers: :func:`filter_hits_sampled_grouped` (one salt over the grid,
the rest per extracted slot, then a prefix-bloom refinement: the kernels
``ops/filter_cuda.grouped_take_extract`` and ``grouped_take_refine``)
where the stride gate holds, else the flat :func:`filter_hits_sampled`
(every cell probed under every salt and the hits compacted in cell order:
``ops/filter_cuda.flat_take_extract``).  Either way the hits are
compacted and verified by an exact DFA walk over their candidate windows,
which emits compacted ``(cell, state*32 + j)`` match records for the host
to expand (on a card the dense and 2-step walks and their compaction are one
launch of ``ops/filter_cuda.verify_records``).  **Anchored**
(:func:`filter_candidates`): every position is tested as a match start
against 1-3 staged bit blooms of class q-gram codes; the survivors are
verified on the host.

32-bit unsigned hash arithmetic is done in int64 with ``& U32_MASK``:
``torch.uint32`` lacks shifts and adds, int32 ``>>`` is arithmetic, and
int32 products must not overflow.  Outputs agree with the JAX package
bit for bit (the fused path in slot order).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..utils.profiling import span
from .scan_torch import (
    INT32_MAX,
    _classes,
    _nonzero_static,
    blocked_nonzero,
    compressed_final,
    compressed_step,
    kgram_decode,
)

KNUTH = 2654435761  # Knuth multiplicative hash constant
#: polynomial rolling-hash base of the sampled gram codes (FNV-1 prime)
GRAM_BASE = 0x01000193
#: second code family of the signature-scale positional bloom, and its
#: probe salt: the grouped take filter re-probes its extracted slots by it
GRAM_BASE2 = 0x31000197
SALT2 = 0x6A09E667
#: grid-block height of the fused filter, and so the survivor-group size
#: of its rank extraction (``cap_coarse`` counts survivors per column)
FUSED_BLOCK_R = 1024
#: record slots per verified window; windows with more final positions
#: emit a sentinel record and are re-walked exactly on the host
VERIFY_KR = 4
#: sentinel ``j`` of a window whose record slots overflowed
REC_OVERFLOW_J = 31
#: state-field width of the packed 2-step verify entry (s2 | s1 << 15)
REC2_BITS = 15

U32_MASK = 0xFFFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """The bits of an int32 tensor as unsigned values in int64."""
    return x.to(torch.int64) & U32_MASK


def mul32(a: torch.Tensor, k: int) -> torch.Tensor:
    """``a * k mod 2**32`` for unsigned 32-bit values ``a`` held in int64,
    with no int64 overflow (``k`` split into 16-bit halves)."""
    lo = a * (k & 0xFFFF)
    hi = ((a * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & U32_MASK


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """Unsigned 32-bit values in int64 -> the same bits as int32."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def gram_codes(cls: torch.Tensor, q: int, n_classes: int) -> torch.Tensor:
    """Rolling base-C q-gram codes: ``code[p]`` covers ``cls[p : p+q]``
    (positions whose gram overruns the row read trailing zeros), wrapping
    in 32 bits like the reference's int32 arithmetic."""
    B, L = cls.shape
    pad = torch.zeros((B, q - 1), dtype=torch.int64, device=cls.device)
    ext = torch.cat([cls.to(torch.int64), pad], dim=1)
    code = torch.zeros((B, L), dtype=torch.int64, device=cls.device)
    for j in range(q):
        code = (code * n_classes + ext[:, j : j + L]) & U32_MASK
    return to_i32(code)


def bloom_slots(code: torch.Tensor, log2_bits: int, salt: int) -> torch.Tensor:
    """Multiplicative hash of a gram code into a bloom slot index."""
    return (mul32(u32(code) ^ salt, KNUTH) >> (32 - log2_bits)).to(torch.int32)


def bloom_hit_take(words: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Bit ``slot`` of the bit bloom ``words`` (int32 0/1 per slot)."""
    w = words[(slots >> 5).long()]
    return (w >> (slots & 31)) & 1


def short_pattern_mask(
    chunks: torch.Tensor, shorts: Sequence[bytes]
) -> torch.Tensor:
    """Exact start positions of short patterns via compare-select."""
    B, L = chunks.shape
    mask = torch.zeros((B, L), dtype=torch.bool, device=chunks.device)
    maxs = max((len(s) for s in shorts), default=0)
    if maxs == 0:
        return mask
    pad = torch.zeros((B, maxs), dtype=torch.uint8, device=chunks.device)
    ext = torch.cat([chunks, pad], dim=1)
    for s in shorts:
        eq = torch.ones((B, L), dtype=torch.bool, device=chunks.device)
        for j, byte in enumerate(s):
            eq &= ext[:, j : j + L] == byte
        mask |= eq
    return mask


def _short_start_words(chunks, lengths, shorts, stride, M):
    """Exact short-pattern starts packed per grid cell (bit ``i`` =>
    short match starting at ``m * stride + i``)."""
    B, L = chunks.shape
    dev = chunks.device
    sm = short_pattern_mask(chunks, shorts)
    sm &= torch.arange(L, device=dev)[None, :] < lengths[:, None]
    pad = torch.zeros((B, M * stride - L), dtype=torch.bool, device=dev)
    cell = torch.cat([sm, pad], dim=1).reshape(B, M, stride)
    acc = torch.zeros((B, M), dtype=torch.int64, device=dev)
    for j in range(stride):
        acc |= cell[:, :, j].to(torch.int64) << j
    return to_i32(acc)


def sampled_gram_codes(
    chunks: torch.Tensor, q: int, stride: int, base: int = GRAM_BASE
) -> torch.Tensor:
    """Polynomial q-gram byte codes ``sum_j byte[p+j] * base^(q-1-j)``
    (wrapping in 32 bits) at the grid positions ``p = m * stride`` only:
    ``[B, M]`` int32, ``M = ceil(L / stride)``.  A gram overrunning its
    row reads zeros.  The reference's cell-aligned planes formulation
    gives the same codes; the grouped take filter computes them so
    (:func:`_word_planes`), from the word pack it needs anyway.

    One strided ``[B, M]`` slice per gram byte, summed in int64 (each
    product is below 2**40), so no ``[B, M, stride]`` intermediate."""
    B, L = chunks.shape
    M = -(-L // stride)
    extra = -(-q // stride)  # whole zero cells covering the gram overhang
    pad = torch.zeros((B, (M + extra) * stride - L), dtype=chunks.dtype,
                      device=chunks.device)
    ext = torch.cat([chunks, pad], dim=1)
    code = torch.zeros((B, M), dtype=torch.int64, device=chunks.device)
    for j in range(q):
        col = ext[:, j : j + (M - 1) * stride + 1 : stride]
        code += col.to(torch.int64) * pow(base, q - 1 - j, 1 << 32)
    return to_i32(code & U32_MASK)


def pack_corpus_words(chunks: torch.Tensor) -> torch.Tensor:
    """``[B, L] uint8 -> [B, L/4] int32`` little-endian word pack: a
    reinterpretation of the bytes (CPUs and CUDA devices are
    little-endian), so no corpus-sized intermediate."""
    return chunks.contiguous().view(torch.int32)


def _word_planes(wc: torch.Tensor, q: int, spc: int):
    """Word ``j4`` of every grid cell's gram, ``j4 < ceil(q / 4)``, as
    ``[B, M]`` int32 planes of the packed corpus ``wc [B, M * spc]``
    (zeros past the row)."""
    B = wc.shape[0]
    planes = []
    for j4 in range((q - 1) // 4 + 1):
        shift, idx = divmod(j4, spc)
        pl = wc[:, idx::spc]
        if shift:
            pl = torch.cat([pl[:, shift:], pl.new_zeros((B, shift))], dim=1)
        planes.append(pl)
    return planes


def _planes_code(planes, q: int, base: int) -> torch.Tensor:
    """Polynomial q-gram codes from the word planes, as unsigned 32-bit
    values in int64 (each term is below 2**40, so the sum cannot
    overflow before the mask)."""
    code = torch.zeros(planes[0].shape, dtype=torch.int64,
                       device=planes[0].device)
    for j in range(q):
        j4, k = divmod(j, 4)
        byte = ((planes[j4] >> (8 * k)) & 0xFF).to(torch.int64)
        code += byte * pow(base, q - 1 - j, 1 << 32)
    return code & U32_MASK


def _salted_probe(words: torch.Tensor, code_u: torch.Tensor, salt: int,
                  log2_words: int) -> torch.Tensor:
    """The positional-bloom word of each code (unsigned in int64) under
    ``salt``: one gather."""
    return words[mul32(code_u ^ salt, KNUTH) >> (32 - log2_words)]


def _flat_extract_torch(words, chunks, sw, mll, *, q, stride, log2_words,
                        salts, capacity):
    """Plain PyTorch version of ``filter_cuda.flat_take_extract`` (the flat
    take filter's codes, probes, gate and ordered compaction); runs on any
    device."""
    code_u = u32(sampled_gram_codes(chunks, q, stride))
    w = None
    for salt in salts:
        probe = _salted_probe(words, code_u, salt, log2_words)
        w = probe if w is None else (w & probe)
    w = torch.where(mll > 0, w, 0).reshape(-1)
    sw = sw.reshape(-1) if sw is not None else torch.zeros_like(w)
    idx, n_hits = blocked_nonzero((w | sw) != 0, capacity)
    safe = torch.clamp(idx, max=w.shape[0] - 1).long()
    valid = idx < INT32_MAX
    return (idx, torch.where(valid, w[safe], 0),
            torch.where(valid, sw[safe], 0), n_hits)


def filter_hits_sampled(
    words: torch.Tensor,  # [2**log2_words] int32 positional bloom
    chunks: torch.Tensor,  # [B, L] uint8
    lengths: torch.Tensor,  # [B] int32
    min_long_len: torch.Tensor,  # scalar int32 (0 disables the long path)
    *,
    q: int,
    stride: int,
    log2_words: int,
    salts: Tuple[int, ...],
    shorts: Tuple[bytes, ...],
    capacity: int,
):
    """Flat take filter: every grid cell's code probes the positional
    bloom once per salt (one gather each), the words AND together (a
    true gram has bit ``j`` set under every salt; stray bits must
    coincide), gated on ``min_long_len``; short-pattern starts are exact.
    The grid hits are compacted in ascending cell order.

    The codes, probes, gate and compaction are one call of
    :func:`~.filter_cuda.flat_take_extract` (its kernel on a CUDA tensor,
    its plain version on a CPU one); the short-start words are made here,
    and only where the plan has shorts.

    Returns ``(grid_idx [capacity] flattened b * M + m ascending,
    INT32_MAX-padded, long_word, short_word, n_hits)`` as device values;
    retry with a bigger ``capacity`` when ``n_hits`` exceeds it.  It has
    no slot capacity, so it serves any density."""
    from .filter_cuda import flat_take_extract

    with span("filter", rows=chunks.shape[0], row_len=chunks.shape[1],
              q=q, stride=stride, bloom_bytes=words.numel() * 4,
              probe_ops=6, route="flat"):
        M = -(-chunks.shape[1] // stride)
        sw = (_short_start_words(chunks, lengths, shorts, stride, M)
              if shorts else None)
        return flat_take_extract(
            words, chunks, sw, min_long_len, q=q, stride=stride,
            log2_words=log2_words, salts=tuple(salts), capacity=capacity)


def filter_hits_sampled_grouped(
    words: torch.Tensor,  # [2**log2_words] int32 positional bloom
    chunks: torch.Tensor,  # [B, L] uint8
    lengths: torch.Tensor,  # [B] int32
    min_long_len: torch.Tensor,  # scalar int32 (0 disables the long path)
    *,
    q: int,
    stride: int,
    log2_words: int,
    salts: Tuple[int, ...],
    shorts: Tuple[bytes, ...],
    capacity: int,
    cap_coarse: int,
    prefix_words=None,  # [2**prefix_log2 / 32] int32 bit bloom, or None
    prefix_salts: Tuple[int, ...] = (),
    prefix_log2: int = 0,
    prefix_len: int = 0,
    block_r: int = FUSED_BLOCK_R,
    words2=None,  # [2**log2_words] int32 second-family bloom, or None
):
    """Grouped take filter, for ``stride % 4 == 0`` and ``stride | L``.

    Two kernels (:mod:`.filter_cuda`; their plain versions on a CPU
    tensor) with one compaction between them.
    :func:`~.filter_cuda.grouped_take_extract` probes only the first salt
    over the grid (codes from the packed corpus words), rank-extracts the
    survivors per (``block_r``-row group, lane) column into ``mpr`` slots
    and re-probes each slot by the remaining salts, or by the second code
    family (``GRAM_BASE2`` under ``SALT2``) when ``words2`` is given.  The
    live slots are compacted.  :func:`~.filter_cuda.grouped_take_refine`
    gathers the compacted hits and refines them: a hit whose long word
    names a single alignment keeps it only if its window prefix hash
    passes the prefix bit bloom.  Refined-dead hits keep their slot with
    ``INT32_MAX`` and zero words.

    Returns ``(grid_idx [capacity] in slot order, long_word, short_word,
    n_final, n_coarse)`` as device values: ``n_final`` counts the hits
    before the refinement (the capacity to cover), ``n_coarse`` is the
    most survivors of one column (retry with a bigger ``cap_coarse``
    when it exceeds it)."""
    from .filter_cuda import grouped_take_extract, grouped_take_refine

    bloom_bytes = words.numel() * 4
    if words2 is not None:
        bloom_bytes += words2.numel() * 4
    with span("filter", rows=chunks.shape[0], row_len=chunks.shape[1],
              q=q, stride=stride, bloom_bytes=bloom_bytes, probe_ops=6,
              route="grouped"):
        B, L = chunks.shape
        if not (stride % 4 == 0 and L % stride == 0):
            raise ValueError(
                "grouped take gate: stride % 4 == 0 and stride | L")
        M = L // stride
        spc = stride // 4
        wc = pack_corpus_words(chunks)
        sw = (_short_start_words(chunks, lengths, shorts, stride, M)
              if shorts else None)
        mpr = min(128, max(8, -(-cap_coarse // 8) * 8))
        r_s, w_s, swo_s, _, cnt = grouped_take_extract(
            words, wc, sw, min_long_len, words2, q=q, spc=spc,
            log2_words=log2_words, salts=tuple(salts), mpr=mpr,
            block_r=block_r,
        )
        # an extracted slot (r_s >= 0) lies in the grid; it lives while a
        # word survived the re-probes
        alive = (r_s >= 0) & ((w_s | swo_s) != 0)
        slot, n_final = blocked_nonzero(alive.reshape(-1), capacity)
        prefix_on = (
            prefix_words is not None
            and stride <= 32
            and 4 <= prefix_len <= 20
            and bool(prefix_salts)
        )
        idx, lw, swo = grouped_take_refine(
            slot, r_s, w_s, swo_s, wc, prefix_words if prefix_on else None,
            mpr=mpr, block_r=block_r, spc=spc,
            prefix_salts=tuple(prefix_salts), prefix_log2=prefix_log2,
            prefix_len=prefix_len,
        )
        return idx, lw, swo, n_final, cnt.max()


def fused_phase_grid(
    chunks: torch.Tensor,  # [B, L] uint8, (4*spc) | L
    spc: int,  # corpus words per grid cell (stride // 4)
    block_r: int = FUSED_BLOCK_R,
) -> torch.Tensor:
    """Corpus word phases in the fused kernel's padded grid layout,
    stacked as one ``[spc, R_pad + 8, 128]`` int32 tensor: phase ``p``
    holds word ``p`` of every grid cell, cells in row-major ``b * M + m``
    order, zero-padded.  Resident-corpus callers compute it once per
    corpus (``DeviceCorpus.fused_phases``)."""
    B, L = chunks.shape
    stride = 4 * spc
    if L % stride:
        raise ValueError("phase grid requires stride | L")
    M = L // stride
    n_grid = B * M
    R = -(-n_grid // 128)
    n_blocks = max(1, -(-R // block_r))
    R_pad = n_blocks * block_r
    wc = pack_corpus_words(chunks).reshape(n_grid, spc).T
    out = torch.zeros((spc, (R_pad + 8) * 128), dtype=torch.int32,
                      device=chunks.device)
    out[:, :n_grid] = wc
    return out.reshape(spc, R_pad + 8, 128)


def fused_extract_args(
    table: torch.Tensor,  # [k * n_banks / pack, 128] int32 bank rows
    chunks: torch.Tensor,  # [B, L] uint8, stride % 4 == 0 and stride | L
    lengths: torch.Tensor,  # [B] int32
    min_long_len: torch.Tensor,  # scalar int32 (0 disables the long path)
    *,
    q: int,
    stride: int,
    log2_rows: int,
    salts: Tuple[int, ...],
    pack: int,
    shorts: Tuple[bytes, ...],
    cap_coarse: int,
    prefix_words=None,
    prefix_salts: Tuple[int, ...] = (),
    prefix_log2: int = 0,
    prefix_len: int = 0,
    phase_g=None,
):
    """``(args, kwargs)`` of the one
    :func:`~.filter_cuda.fused_sampled_extract` launch that
    :func:`filter_hits_sampled_vmem` makes on these rows (the alignment
    gate holding): the short-start words, the phase grid (``phase_g`` when
    given), the slots a block column keeps and the in-kernel prefix
    refinement."""
    B, L = chunks.shape
    M = L // stride
    prefix_on = (
        prefix_words is not None
        and stride <= 16
        and 4 <= prefix_len <= 20
        and bool(prefix_salts)
    )
    spc = stride // 4
    block_r = FUSED_BLOCK_R
    n_grid = B * M
    R = -(-n_grid // 128)
    n_blocks = max(1, -(-R // block_r))
    R_pad = n_blocks * block_r
    sw_g = None
    if shorts:
        sw = _short_start_words(chunks, lengths, shorts, stride, M)
        sw_g = torch.zeros(R_pad * 128, dtype=torch.int32,
                           device=chunks.device)
        sw_g[:n_grid] = sw.reshape(-1)
        sw_g = sw_g.reshape(R_pad, 128)
    if phase_g is None:
        phase_g = fused_phase_grid(chunks, spc=spc, block_r=block_r)
    mll = min_long_len.to(torch.int32).reshape(1, 1)
    mpr = min(128, max(8, -(-cap_coarse // 8) * 8))
    # small prefix blooms (<= 32 [*, 128] rows) are probed in the kernel
    pb_rows = (1 << prefix_log2) // 32 // 128 if prefix_on else 0
    inkernel_refine = prefix_on and 0 < pb_rows <= 32
    kw = dict(
        salts=tuple(salts), log2_rows=log2_rows, pack=pack, q=q, spc=spc,
        mpr=mpr, block_r=block_r, n_grid=n_grid,
        l16=prefix_len if prefix_on else 0, prefix_on=prefix_on,
        prefix_table=(
            prefix_words.reshape(pb_rows, 128) if inkernel_refine else None
        ),
        prefix_salts=tuple(prefix_salts) if inkernel_refine else (),
        prefix_log2=prefix_log2 if inkernel_refine else 0,
    )
    return (table, phase_g, sw_g, mll), kw


def filter_hits_sampled_vmem(
    table: torch.Tensor,  # [k * n_banks / pack, 128] int32 bank rows
    words: torch.Tensor,  # [2**log2_words] int32 positional bloom
    chunks: torch.Tensor,  # [B, L] uint8
    lengths: torch.Tensor,  # [B] int32
    min_long_len: torch.Tensor,  # scalar int32 (0 disables the long path)
    *,
    q: int,
    stride: int,
    log2_rows: int,
    salts: Tuple[int, ...],
    pack: int,
    log2_words: int,
    fine_salts: Tuple[int, ...],
    shorts: Tuple[bytes, ...],
    capacity: int,
    cap_coarse: int,
    prefix_words=None,  # [2**prefix_log2 / 32] int32 bit bloom, or None
    prefix_salts: Tuple[int, ...] = (),
    prefix_log2: int = 0,
    prefix_len: int = 0,
    phase_g=None,  # precomputed fused_phase_grid output (resident corpus)
):
    """Two-stage sampled filter through the fused kernel.

    Stage 1 is one :func:`~.filter_cuda.fused_sampled_extract` launch
    (``cap_coarse`` = survivors per block column).  Stage 2 refines the
    slots: in the kernel against a small prefix bloom, else by one
    prefix-bloom bit probe per single-alignment slot, else (no prefix
    plan) by a re-probe of the fine positional bloom.  Returns
    ``(grid_idx [capacity] in slot order, INT32_MAX-padded, long_word,
    short_word, n_final, n_coarse)``; retry bigger when either count
    overflows.

    Where the alignment gate fails (``stride % 4``, ``stride`` not
    dividing ``L``, or ``cap_coarse > 128``) the per-row filter
    :func:`_filter_hits_sampled_vmem_rows` serves instead, with the same
    contract (``cap_coarse`` = survivors per 128-lane row, ``grid_idx``
    ascending)."""
    from .filter_cuda import fused_sampled_extract

    with span("filter", rows=chunks.shape[0], row_len=chunks.shape[1],
              q=q, stride=stride, bloom_bytes=table.numel() * 4,
              probe_ops=12, route="vmem"):
        B, L = chunks.shape
        M = -(-L // stride)
        if not (stride % 4 == 0 and L % stride == 0 and cap_coarse <= 128):
            return _filter_hits_sampled_vmem_rows(
                table, words, chunks, lengths, min_long_len,
                q=q, stride=stride, log2_rows=log2_rows, salts=salts, pack=pack,
                log2_words=log2_words, fine_salts=fine_salts, shorts=shorts,
                capacity=capacity, cap_coarse=cap_coarse,
            )
        dev = chunks.device
        args, kw = fused_extract_args(
            table, chunks, lengths, min_long_len,
            q=q, stride=stride, log2_rows=log2_rows, salts=salts, pack=pack,
            shorts=shorts, cap_coarse=cap_coarse, prefix_words=prefix_words,
            prefix_salts=prefix_salts, prefix_log2=prefix_log2,
            prefix_len=prefix_len, phase_g=phase_g,
        )
        r_s, w_s, swo_s, h_s, cnt = fused_sampled_extract(*args, **kw)
        prefix_on = kw["prefix_on"]
        inkernel_refine = kw["prefix_table"] is not None
        mpr, block_r, n_grid = kw["mpr"], kw["block_r"], kw["n_grid"]
        R = -(-n_grid // 128)
        n_blocks = max(1, -(-R // block_r))

        if inkernel_refine:
            long_ok = w_s != 0  # refinement already applied in the kernel
        elif prefix_on:
            # stage 2a: one prefix-bloom bit probe per single-alignment slot
            ok = None
            for salt in prefix_salts:
                slot = mul32(u32(h_s) ^ salt, KNUTH) >> (32 - prefix_log2)
                word = prefix_words[slot >> 5].to(torch.int64)
                bit = (word >> (slot & 31)) & 1
                ok = bit if ok is None else (ok & bit)
            v = w_s & ((1 << stride) - 1)
            single = (v != 0) & ((v & (v - 1)) == 0)
            long_ok = (w_s != 0) & (torch.logical_not(single) | (ok == 1))
        else:
            # stage 2: fine re-probe of the positional bloom (h_s = code)
            wf = None
            for salt in fine_salts:
                probe = _salted_probe(words, u32(h_s), salt, log2_words)
                wf = probe if wf is None else (wf & probe)
            w_s = w_s & wf
            long_ok = w_s != 0

        nrows = n_blocks * mpr
        blk = (torch.arange(nrows, dtype=torch.int32, device=dev)
               // mpr)[:, None]
        lane = torch.arange(128, dtype=torch.int32, device=dev)[None, :]
        cell_s = (blk * block_r + r_s) * 128 + lane
        alive = (r_s >= 0) & (long_ok | (swo_s != 0)) & (cell_s < n_grid)
        slot, n_final = blocked_nonzero(alive.reshape(-1), capacity)
        tot = nrows * 128
        safe = torch.clamp(slot, max=tot - 1).long()
        valid = slot < INT32_MAX
        idx = torch.where(valid, cell_s.reshape(-1)[safe], INT32_MAX)
        lw = torch.where(valid, w_s.reshape(-1)[safe], 0)
        swo = torch.where(valid, swo_s.reshape(-1)[safe], 0)
        # slot order (block-major), not cell-ascending: window verify treats
        # slots independently and the host expansion re-orders
        return idx, lw, swo, n_final, cnt.max()


def _filter_hits_sampled_vmem_rows(
    table: torch.Tensor,  # [k * n_banks / pack, 128] int32 bank rows
    words: torch.Tensor,  # [2**log2_words] int32 positional bloom
    chunks: torch.Tensor,  # [B, L] uint8
    lengths: torch.Tensor,  # [B] int32
    min_long_len: torch.Tensor,  # scalar int32 (0 disables the long path)
    *,
    q: int,
    stride: int,
    log2_rows: int,
    salts: Tuple[int, ...],
    pack: int,
    log2_words: int,
    fine_salts: Tuple[int, ...],
    shorts: Tuple[bytes, ...],
    capacity: int,
    cap_coarse: int,
):
    """Per-row sampled filter, for plans the fused kernel cannot take.

    Stage 1: every grid cell's code probes the ``k`` bank blooms through
    :func:`~.filter_cuda.bloom_word_vmem`; short-pattern starts are
    exact.  Stage 1.5: survivors are rank-extracted per 128-lane grid row
    into ``[mpr, R]`` slot arrays, slot ``k`` of row ``r`` holding its
    ``(k+1)``-th hit (the reference's ``mpr`` masked one-lane sums; one
    scatter here, equal because at most one lane of a row has a given
    rank).  Stage 2: every slot re-probes the fine positional bloom;
    the survivors are compacted and sorted back to ascending cells.

    Returns ``(grid_idx [capacity] ascending, INT32_MAX-padded,
    long_word, short_word, n_final, n_coarse)`` as device values (no host
    synchronisation); ``n_coarse`` is the most hits of one row, so retry
    with a bigger ``cap_coarse`` when it exceeds it and a bigger
    ``capacity`` when ``n_final`` does."""
    from .filter_cuda import bloom_word_vmem

    B, L = chunks.shape
    M = -(-L // stride)
    dev = chunks.device
    code = sampled_gram_codes(chunks, q, stride)
    w = bloom_word_vmem(table, code, salts, log2_rows, pack)
    w = torch.where(min_long_len > 0, w, 0)
    if shorts:
        sw = _short_start_words(chunks, lengths, shorts, stride, M)
    else:
        sw = torch.zeros((B, M), dtype=torch.int32, device=dev)

    # stage 1.5: rank-extract survivors per 128-lane grid row
    n_grid = B * M
    R = -(-n_grid // 128)
    mpr = min(max(cap_coarse, 1), 128)

    def rows(x):
        out = torch.zeros(R * 128, dtype=torch.int32, device=dev)
        out[:n_grid] = x.reshape(-1)
        return out.reshape(R, 128)

    w2, sw2, code2 = rows(w), rows(sw), rows(code)
    hit = (w2 | sw2) != 0
    ranks = torch.cumsum(hit.to(torch.int32), dim=1, dtype=torch.int32)
    n_coarse = ranks[:, -1].max()  # retry signal: > mpr means loss
    n_slots = mpr * R
    row_i = torch.arange(R, device=dev)[:, None]
    lane_i = torch.arange(128, dtype=torch.int32, device=dev)
    # every kept hit owns a distinct slot (rank - 1, row); the rest all
    # land in one spare slot past the end, which is cut off
    dst = torch.where(hit & (ranks <= mpr), (ranks.long() - 1) * R + row_i,
                      n_slots).reshape(-1)

    def slots(fill, values):
        out = torch.full((n_slots + 1,), fill, dtype=torch.int32, device=dev)
        out.scatter_(0, dst, values.reshape(-1))
        return out[:n_slots]

    lane_s = slots(-1, lane_i.expand(R, 128))
    w_s = slots(0, w2)
    sw_s = slots(0, sw2)
    c_s = slots(0, code2)

    # stage 2: every slot re-probes the fine positional bloom
    wf = None
    for salt in fine_salts:
        probe = _salted_probe(words, u32(c_s), salt, log2_words)
        wf = probe if wf is None else (wf & probe)
    w_s = w_s & wf

    # compaction over the slot array, then back to ascending cells
    alive = (w_s | sw_s) != 0
    slot, n_final = blocked_nonzero(alive, capacity)
    safe = torch.clamp(slot, max=n_slots - 1).long()
    valid = slot < INT32_MAX
    cell = lane_s[safe] + (safe % R).to(torch.int32) * 128
    idx = torch.where(valid, cell, INT32_MAX)
    lw = torch.where(valid, w_s[safe], 0)
    swo = torch.where(valid, sw_s[safe], 0)
    # ties only among the INT32_MAX pads, whose words are all 0
    idx, perm = torch.sort(idx, stable=True)
    return idx, lw[perm], swo[perm], n_final, n_coarse


def _window_classes(byte_class, used_bytes, chunks, base, W):
    """Byte classes of every window ``[base, base + W)`` (indices clamped
    into the corpus; out-of-row positions are masked by the callers)."""
    B, L = chunks.shape
    j_idx = torch.arange(W, device=chunks.device)[None, :]
    bidx = torch.clamp(base.long()[:, None] + j_idx, 0, B * L - 1)
    byte = chunks.reshape(-1)[bidx]
    return _classes(byte, byte_class, used_bytes)


def _window_geometry(chunks, lengths, emit_from, grid_idx, stride, n_hits):
    B, L = chunks.shape
    M = -(-L // stride)
    H = min(n_hits, grid_idx.shape[0])
    grid_idx = grid_idx[:H]
    active = grid_idx < INT32_MAX
    g = torch.where(active, grid_idx, 0)
    b = g // M
    w0 = (g % M) * stride - (stride - 1)
    base = b * L + w0
    bl = b.long()
    row_emit = None if emit_from is None else emit_from[bl]
    return grid_idx, H, active, w0, base, lengths[bl], row_emit


def _emit_records(grid_idx, H, cnt, slots, capacity):
    """Compact the per-window record slots (slot-major) into
    ``(rec_cell, rec_pack, n_rec)``."""
    over = cnt > VERIFY_KR
    slots = slots + [torch.where(over, REC_OVERFLOW_J, 0).to(torch.int32)]
    used = [cnt > k for k in range(VERIFY_KR)] + [over]
    alive = torch.stack(used).reshape(-1)  # [KR+1, H] slot-major
    slot_idx, n_rec = blocked_nonzero(alive, capacity)
    tot = (VERIFY_KR + 1) * H
    safe = torch.clamp(slot_idx, max=tot - 1).long()
    valid = slot_idx < INT32_MAX
    pk = torch.stack(slots).reshape(-1)
    cells = grid_idx[safe % H]
    rec_cell = torch.where(valid, cells, INT32_MAX)
    rec_pack = torch.where(valid, pk[safe], 0)
    return rec_cell, rec_pack, n_rec


def _record_step(s_j, final_j, pos_j, valid_j, j, row_emit, cnt, slots):
    fin = final_j & valid_j & (pos_j >= row_emit)
    pack = s_j * 32 + j
    for k in range(VERIFY_KR):
        slots[k] = torch.where(fin & (cnt == k), pack, slots[k])
    return cnt + fin.to(torch.int32)


def _verify_records_torch(
    table, byte_class, used_bytes, chunks, lengths, emit_from, grid_idx,
    final_start, *, n_classes, stride, win_len, capacity, n_hits, step=1,
):
    """Plain PyTorch version of :func:`~.filter_cuda.verify_records`: the
    window walk of :func:`verify_windows_records` (``step`` 1) or of
    :func:`verify_windows_records2` (``step`` 2), a few small ops a
    window position, then the records' compaction.  Runs on any device."""
    grid_idx, H, active, w0, base, row_len, row_emit = _window_geometry(
        chunks, lengths, emit_from, grid_idx, stride, n_hits
    )
    W = win_len
    cls = _window_classes(byte_class, used_bytes, chunks, base, W)
    dev = chunks.device
    state = torch.zeros(H, dtype=torch.int32, device=dev)
    cnt = torch.zeros(H, dtype=torch.int32, device=dev)
    slots = [torch.zeros(H, dtype=torch.int32, device=dev)
             for _ in range(VERIFY_KR)]
    if step == 1:
        for j in range(W):
            pos_j = w0 + j
            valid_j = (pos_j >= 0) & (pos_j < row_len) & active
            cls_j = torch.where(valid_j, cls[:, j], 0)
            state = table[state.long() * n_classes + cls_j].to(
                torch.int32)
            cnt = _record_step(state, state >= final_start, pos_j, valid_j, j,
                               row_emit, cnt, slots)
        return _emit_records(grid_idx, H, cnt, slots, capacity)
    smask = (1 << REC2_BITS) - 1
    C2 = n_classes * n_classes
    for t in range(-(-W // 2)):
        j1, j2 = 2 * t, 2 * t + 1
        pos1 = w0 + j1
        valid1 = (pos1 >= 0) & (pos1 < row_len) & active
        c1 = torch.where(valid1, cls[:, j1], 0)
        if j2 < W:
            pos2 = w0 + j2
            valid2 = (pos2 >= 0) & (pos2 < row_len) & active
            c2 = torch.where(valid2, cls[:, j2], 0)
        else:  # dead half-step: class 0, never emits
            pos2, valid2, c2 = (pos1, torch.zeros_like(valid1),
                                torch.zeros_like(c1))
        entry = table[
            state.long() * C2 + c1.long() * n_classes + c2
        ].to(torch.int32)
        s1 = entry >> REC2_BITS
        s2 = entry & smask
        cnt = _record_step(s1, s1 >= final_start, pos1, valid1, j1,
                           row_emit, cnt, slots)
        if j2 < W:
            cnt = _record_step(s2, s2 >= final_start, pos2, valid2, j2,
                               row_emit, cnt, slots)
        state = s2
    return _emit_records(grid_idx, H, cnt, slots, capacity)


def verify_windows_records(
    table_flat: torch.Tensor,  # [S*C] int16/int32 dense transition table
    byte_class: torch.Tensor,
    used_bytes: torch.Tensor,
    chunks: torch.Tensor,  # [B, L] uint8
    lengths: torch.Tensor,  # [B] int32
    emit_from: torch.Tensor,  # [B] int32
    grid_idx: torch.Tensor,  # [>=n_hits] int32 b*M+m hits, INT32_MAX-padded
    final_start: torch.Tensor,  # scalar int32
    *,
    n_classes: int,
    stride: int,
    win_len: int,  # <= 31 (REC_OVERFLOW_J is reserved)
    capacity: int,
    n_hits: int,
):
    """Exact window walk with match-record emission: one
    ``(cell, state*32 + j)`` record per final position of each verified
    window (up to ``VERIFY_KR``; more emit one ``REC_OVERFLOW_J``
    sentinel for an exact host re-walk).  Returns ``(rec_cell [cap],
    rec_pack [cap], n_rec)`` in slot order; retry when ``n_rec >
    capacity``.  A CUDA table walks and compacts in one launch of
    ``csrc/verify_records.cu`` (:func:`~.filter_cuda.verify_records`); a
    CPU one runs :func:`_verify_records_torch`."""
    from .filter_cuda import verify_records

    with span("verify", capacity=capacity, hits=n_hits,
              table_bytes=table_flat.nbytes):
        return verify_records(
            table_flat, byte_class, used_bytes, chunks, lengths, emit_from,
            grid_idx, final_start, n_classes=n_classes, stride=stride,
            win_len=win_len, capacity=capacity, n_hits=n_hits, step=1,
        )


def verify_windows_records_compressed(
    dense_flat: torch.Tensor,  # [D*C] int32 dense-bank rows
    meta: torch.Tensor,  # [S-D] int32 skip * EXC_PACK + exc_class + 1
    exc_target: torch.Tensor,  # [S-D] int32
    byte_class: torch.Tensor,
    used_bytes: torch.Tensor,
    chunks: torch.Tensor,  # [B, L] uint8
    lengths: torch.Tensor,  # [B] int32
    emit_from: torch.Tensor,  # [B] int32
    grid_idx: torch.Tensor,  # [>=n_hits] int32 b*M+m hits, INT32_MAX-padded
    dense_final_start: torch.Tensor,  # scalar int32
    final_start: torch.Tensor,  # scalar int32
    *,
    n_classes: int,
    n_dense: int,
    stride: int,
    win_len: int,  # <= 31 (REC_OVERFLOW_J is reserved)
    capacity: int,
    n_hits: int,
):
    """:func:`verify_windows_records` over the compressed table: the walk
    is the 3-gather compressed step and finality its two-range
    predicate, with the same record slots and overflow sentinel."""
    with span("verify", capacity=capacity, hits=n_hits,
              table_bytes=dense_flat.nbytes + meta.nbytes
              + exc_target.nbytes):
        grid_idx, H, active, w0, base, row_len, row_emit = _window_geometry(
            chunks, lengths, emit_from, grid_idx, stride, n_hits
        )
        W = win_len
        cls = _window_classes(byte_class, used_bytes, chunks, base, W)
        dev = chunks.device
        state = torch.zeros(H, dtype=torch.int32, device=dev)
        cnt = torch.zeros(H, dtype=torch.int32, device=dev)
        slots = [torch.zeros(H, dtype=torch.int32, device=dev)
                 for _ in range(VERIFY_KR)]
        for j in range(W):
            pos_j = w0 + j
            valid_j = (pos_j >= 0) & (pos_j < row_len) & active
            c = torch.where(valid_j, cls[:, j], 0)
            state = compressed_step(state, c, dense_flat, meta, exc_target,
                                    n_classes, n_dense)
            fin = compressed_final(state, n_dense, dense_final_start,
                                   final_start)
            cnt = _record_step(state, fin, pos_j, valid_j, j, row_emit, cnt,
                               slots)
        return _emit_records(grid_idx, H, cnt, slots, capacity)


def verify_windows_records2(
    table2_flat: torch.Tensor,  # [S * C * C] int32 packed 2-step entries
    byte_class: torch.Tensor,
    used_bytes: torch.Tensor,
    chunks: torch.Tensor,  # [B, L] uint8
    lengths: torch.Tensor,  # [B] int32
    emit_from: torch.Tensor,  # [B] int32
    grid_idx: torch.Tensor,  # [>=n_hits] int32 b*M+m hits, INT32_MAX-padded
    final_start: torch.Tensor,  # scalar int32
    *,
    n_classes: int,
    stride: int,
    win_len: int,  # <= 31 (REC_OVERFLOW_J is reserved)
    capacity: int,
    n_hits: int,
):
    """:func:`verify_windows_records` in 2-class super-steps: the packed
    table ``table2[s, c1*C + c2] = s2 | (s1 << 15)`` advances two window
    positions per dependent gather, and the intermediate state ``s1``
    rides in the entry's high bits so finals at both positions are
    detected.  Requires ``S < 2**15``; positions outside ``[0, length)``
    contribute class 0 exactly like the 1-step walk.  Launches like
    :func:`verify_windows_records`."""
    from .filter_cuda import verify_records

    with span("verify", capacity=capacity, hits=n_hits,
              table_bytes=table2_flat.nbytes):
        return verify_records(
            table2_flat, byte_class, used_bytes, chunks, lengths, emit_from,
            grid_idx, final_start, n_classes=n_classes, stride=stride,
            win_len=win_len, capacity=capacity, n_hits=n_hits, step=2,
        )


def records_chain_vmem(
    vmem_table,
    words,
    prefix_words,
    table_flat,  # dense [S*C], the packed 2-step table with use_k2, or
    # the dense-bank rows with compressed
    byte_class,
    used_bytes,
    chunks,
    lengths,
    emit_from,
    min_long_len,
    final_start,
    phase_g,  # fused_phase_grid output, or None
    *,
    q: int,
    stride: int,
    log2_rows: int,
    salts: Tuple[int, ...],
    pack: int,
    log2_words: int,
    fine_salts: Tuple[int, ...],
    shorts: Tuple[bytes, ...],
    cap_a: int,
    cap_coarse: int,
    prefix_salts: Tuple[int, ...],
    prefix_log2: int,
    prefix_len: int,
    n_classes: int,
    win_len: int,
    cap_r: int,
    compressed: bool = False,
    use_k2: bool = False,
    meta=None,  # compressed only
    exc_target=None,  # compressed only
    dense_final_start=None,  # compressed only
    n_dense: int = 0,  # compressed only
):
    """Fused filter + record verification (the compressed table's walk
    with ``compressed``).  Returns ``(rec_cell, rec_pack, n_hits, n_rec,
    n_coarse)`` as device values (no host fetch); retry bigger when a
    count exceeds its capacity."""
    idx, _lw, _sw, n, nc = filter_hits_sampled_vmem(
        vmem_table, words, chunks, lengths, min_long_len,
        q=q, stride=stride, log2_rows=log2_rows, salts=salts, pack=pack,
        log2_words=log2_words, fine_salts=fine_salts, shorts=shorts,
        capacity=cap_a, cap_coarse=cap_coarse,
        prefix_words=prefix_words if prefix_salts else None,
        prefix_salts=prefix_salts, prefix_log2=prefix_log2,
        prefix_len=prefix_len, phase_g=phase_g,
    )
    if compressed:
        rc, rp, nr = verify_windows_records_compressed(
            table_flat, meta, exc_target, byte_class, used_bytes, chunks,
            lengths, emit_from, idx, dense_final_start, final_start,
            n_classes=n_classes, n_dense=n_dense, stride=stride,
            win_len=win_len, capacity=cap_r, n_hits=cap_a,
        )
        return rc, rp, n, nr, nc
    verify = verify_windows_records2 if use_k2 else verify_windows_records
    rc, rp, nr = verify(
        table_flat, byte_class, used_bytes, chunks, lengths, emit_from,
        idx, final_start,
        n_classes=n_classes, stride=stride, win_len=win_len,
        capacity=cap_r, n_hits=cap_a,
    )
    return rc, rp, n, nr, nc


def _flagged_cells(grid_idx, H, flagged, capacity):
    """Grid ids of the flagged windows (ascending, INT32_MAX-padded) and
    their count."""
    slot = _nonzero_static(flagged, capacity)
    safe = torch.clamp(slot, max=H - 1)
    win_cell = torch.where(slot < INT32_MAX, grid_idx[safe], INT32_MAX)
    return win_cell, flagged.sum(dtype=torch.int32)


def verify_windows(
    table_flat: torch.Tensor,  # [S*C] int16/int32 dense transition table
    byte_class: torch.Tensor,
    used_bytes: torch.Tensor,
    chunks: torch.Tensor,  # [B, L] uint8
    lengths: torch.Tensor,  # [B] int32
    grid_idx: torch.Tensor,  # [>=n_hits] int32 b*M+m hits, INT32_MAX-padded
    final_start: torch.Tensor,  # scalar int32
    *,
    n_classes: int,
    stride: int,
    win_len: int,  # (stride - 1) + max pattern length, <= 32
    capacity: int,
    n_hits: int,
):
    """Flagged-window verification: walk the dense DFA over each hit's
    window ``[p - stride + 1, p + max_len)`` from the root and flag the
    windows that reach a final state at a position inside their row
    (outside positions take class 0, which pins the walk at the root).
    Returns ``(win_cell [capacity], n_flagged)``: grid ids of the flagged
    windows, ascending, INT32_MAX-padded.  The host re-walks only those
    (``CascadeModel.emit_windows_arrays``)."""
    grid_idx, H, active, w0, base, row_len, _ = _window_geometry(
        chunks, lengths, None, grid_idx, stride, n_hits
    )
    cls = _window_classes(byte_class, used_bytes, chunks, base, win_len)
    state = torch.zeros(H, dtype=torch.int32, device=chunks.device)
    flagged = torch.zeros(H, dtype=torch.bool, device=chunks.device)
    for j in range(win_len):
        pos_j = w0 + j
        valid_j = (pos_j >= 0) & (pos_j < row_len) & active
        cls_j = torch.where(valid_j, cls[:, j], 0)
        state = table_flat[state.long() * n_classes + cls_j].to(torch.int32)
        flagged |= (state >= final_start) & valid_j
    return _flagged_cells(grid_idx, H, flagged, capacity)


def verify_windows_kgram(
    ktable: torch.Tensor,  # [S * C^kv] int16/int32 packed k-gram entries
    byte_class: torch.Tensor,
    used_bytes: torch.Tensor,
    chunks: torch.Tensor,  # [B, L] uint8
    lengths: torch.Tensor,  # [B] int32
    grid_idx: torch.Tensor,  # [>=n_hits] int32 b*M+m hits, INT32_MAX-padded
    final_start: torch.Tensor,  # scalar int32
    *,
    n_classes: int,
    kv: int,
    stride: int,
    win_len: int,
    capacity: int,
    n_hits: int,
):
    """:func:`verify_windows` in ``kv``-class super-steps through the
    k-gram table (``models/kgram_dfa.py``): its mid-final flag covers the
    positions strictly inside a step, and the end state's finality is one
    compare, so the window takes ``ceil(win_len / kv)`` dependent gathers.
    Positions outside the row and past the window take class 0, which
    leads every state to the root: a masked position is never final, so
    the flags equal the 1-step walk's.  Requires ``n_classes <= 255``."""
    assert n_classes <= 255, "kgram verify requires byte-sized classes"
    grid_idx, H, active, w0, base, row_len, _ = _window_geometry(
        chunks, lengths, None, grid_idx, stride, n_hits
    )
    W = win_len
    cls = _window_classes(byte_class, used_bytes, chunks, base, W)
    dev = chunks.device
    ck = n_classes**kv
    state = torch.zeros(H, dtype=torch.int32, device=dev)
    flagged = torch.zeros(H, dtype=torch.bool, device=dev)
    zero = torch.zeros(H, dtype=torch.int32, device=dev)
    for t in range(-(-W // kv)):
        code = zero
        for d in range(kv):
            j = t * kv + d
            if j < W:
                pos_j = w0 + j
                valid_j = (pos_j >= 0) & (pos_j < row_len) & active
                c = torch.where(valid_j, cls[:, j], 0)
            else:
                c = zero
            code = code * n_classes + c
        state, mid = kgram_decode(ktable[state.long() * ck + code])
        flagged |= mid | (state >= final_start)
    return _flagged_cells(grid_idx, H, flagged, capacity)


def verify_windows_compressed(
    dense_flat: torch.Tensor,  # [D*C] int32 dense-bank rows
    meta: torch.Tensor,  # [S-D] int32 skip * EXC_PACK + exc_class + 1
    exc_target: torch.Tensor,  # [S-D] int32
    byte_class: torch.Tensor,
    used_bytes: torch.Tensor,
    chunks: torch.Tensor,  # [B, L] uint8
    lengths: torch.Tensor,  # [B] int32
    grid_idx: torch.Tensor,  # [>=n_hits] int32 b*M+m hits, INT32_MAX-padded
    dense_final_start: torch.Tensor,  # scalar int32
    final_start: torch.Tensor,  # scalar int32
    *,
    n_classes: int,
    n_dense: int,
    stride: int,
    win_len: int,
    capacity: int,
    n_hits: int,
):
    """:func:`verify_windows` over the compressed table (3 gathers a
    step, the two-range finality): the flagged-window verifier of
    signature-scale sets whose dense table is not built."""
    grid_idx, H, active, w0, base, row_len, _ = _window_geometry(
        chunks, lengths, None, grid_idx, stride, n_hits
    )
    cls = _window_classes(byte_class, used_bytes, chunks, base, win_len)
    state = torch.zeros(H, dtype=torch.int32, device=chunks.device)
    flagged = torch.zeros(H, dtype=torch.bool, device=chunks.device)
    for j in range(win_len):
        pos_j = w0 + j
        valid_j = (pos_j >= 0) & (pos_j < row_len) & active
        c = torch.where(valid_j, cls[:, j], 0)
        state = compressed_step(state, c, dense_flat, meta, exc_target,
                                n_classes, n_dense)
        flagged |= compressed_final(
            state, n_dense, dense_final_start, final_start
        ) & valid_j
    return _flagged_cells(grid_idx, H, flagged, capacity)


def filter_candidates(
    bloom_words: torch.Tensor,  # [n_stages, bits/32] int32
    byte_class: torch.Tensor,
    used_bytes: torch.Tensor,
    chunks: torch.Tensor,  # [B, L] uint8
    lengths: torch.Tensor,  # [B] int32
    min_long_len: torch.Tensor,  # scalar int32 (0 disables the long path)
    *,
    n_classes: int,
    q: int,
    offsets: Tuple[int, ...],
    log2_bits: int,
    salts: Tuple[int, ...],
    shorts: Tuple[bytes, ...],
    capacity: int,
):
    """Anchored candidate starts.  Returns ``(start_idx [capacity],
    n_candidates)``: flattened ``b * L + p`` ascending, INT32_MAX-padded.

    A position is a candidate iff every bloom stage passes (a potential
    long-pattern start with ``min_long_len`` bytes left in its row) or a
    short pattern begins there exactly, and it lies inside its row.  The
    stages are probed through :func:`~.filter_cuda.bloom_hit`: its kernel
    on a CUDA bloom, :func:`bloom_hit_take` on a CPU one."""
    from .filter_cuda import bloom_hit as hit

    B, L = chunks.shape
    dev = chunks.device
    p_idx = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    if offsets:  # long-pattern bloom stages (absent in shorts-only plans)
        cls = _classes(chunks, byte_class, used_bytes)
        code = gram_codes(cls, q, n_classes)
        pad = torch.zeros((B, max(offsets)), dtype=torch.int32, device=dev)
        code_ext = torch.cat([code, pad], dim=1)
        cand = torch.ones((B, L), dtype=torch.bool, device=dev)
        for s, (off, salt) in enumerate(zip(offsets, salts)):
            slots = bloom_slots(code_ext[:, off : off + L], log2_bits, salt)
            cand &= hit(bloom_words[s], slots) != 0
        cand &= p_idx + min_long_len <= lengths[:, None]
        cand &= min_long_len > 0
    else:
        cand = torch.zeros((B, L), dtype=torch.bool, device=dev)
    if shorts:
        cand |= short_pattern_mask(chunks, shorts)
    # any match from start p ends at >= p: drop starts past the row
    cand &= p_idx < lengths[:, None]
    return blocked_nonzero(cand.reshape(-1), capacity)
