"""Bloom filter kernels: the hand-written Hopper kernels and their plain
PyTorch versions.

Counterpart of the JAX package's ``ops/filter_pallas.py``, one kernel for
each of its Pallas kernels:

- :func:`fused_sampled_extract` (``csrc/fused_sampled_extract.cu``), the
  fused sampled filter below;
- :func:`bloom_word_vmem` (``csrc/bloom_word_vmem.cu``), the salted
  bank-bloom AND of the per-row sampled filter; plain version
  :func:`_bank_probe_torch`;
- :func:`bloom_hit` (``csrc/bloom_hit.cu``), one bit of a bit bloom per
  slot, for the anchored candidate filter; plain version
  ``filter_torch.bloom_hit_take``.

and two for the grouped take filter
(``filter_torch.filter_hits_sampled_grouped``), whose reference is XLA
code (``filter_jax.filter_hits_sampled_grouped``), not a Pallas kernel:

- :func:`grouped_take_extract` (``csrc/grouped_take_extract.cu``), its
  grid stage: q-gram codes from the packed corpus, the first salt's probe
  of the positional bloom, rank extraction per (``block_r``-row group,
  lane) column and the per-slot re-probes; plain version
  :func:`_grouped_extract_torch`;
- :func:`grouped_take_refine` (``csrc/grouped_take_refine.cu``), its
  refinement of the compacted hits: the slot gathers, the window's prefix
  hash and its bit in the prefix bit bloom (``bloom_hit``'s test, made in
  the pass that computes the slot); plain version
  :func:`_grouped_refine_torch`.

and one for the flat take filter (``filter_torch.filter_hits_sampled``),
whose reference is XLA code too (``filter_jax.filter_hits_sampled``):

- :func:`flat_take_extract` (``csrc/flat_take_extract.cu``), every grid
  cell's code and probes under every salt, the gate, the hit test and
  the hits' compaction in ascending cell order; plain version
  ``filter_torch._flat_extract_torch``.

and one for the records verify (``filter_torch.verify_windows_records``
and ``verify_windows_records2``), whose reference is XLA code too
(``filter_jax.verify_windows_records``, ``verify_windows_records2``):

- :func:`verify_records` (``csrc/verify_records.cu``), every hit slot's
  window walk, its record slots and the records' compaction in one launch;
  plain version ``filter_torch._verify_records_torch``.

For every stride cell of the corpus grid the fused filter

1. assembles the q-gram code from the ``spc`` corpus word phases,
2. ANDs ``k`` salted bank-bloom words (``pack`` sub-words per physical
   word), gated by ``min_long_len``,
3. with ``prefix_on``, takes the ``l16``-byte polynomial hash of the
   candidate window named by the lowest set alignment bit,
4. rank-extracts up to ``mpr`` survivors per (1024-row block, lane)
   column into ``[n_blocks * mpr, 128]`` slot arrays plus per-column
   survivor counts, and
5. optionally refines the slots against the small prefix bit bloom.

Each wrapper is declared with ``_build.hand_kernel``: on a CUDA tensor
it launches its kernel (counted in its ``launches`` attribute) and never
falls back; on a CPU tensor it runs its plain version, which the tests
hold bit for bit against the JAX package's own mirror of the Pallas
kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ._build import hand_kernel
from .filter_torch import (
    FUSED_BLOCK_R, GRAM_BASE, GRAM_BASE2, INT32_MAX, KNUTH, SALT2, U32_MASK,
    _flat_extract_torch, _planes_code, _salted_probe, _verify_records_torch,
    _word_planes, bloom_hit_take, bloom_slots, mul32, to_i32, u32,
)


def _bank_probe_torch(table, codes, salts, log2_rows, pack=1):
    """AND over ``salts`` of each code's salted bloom word (flat probe of
    the ``[k * N / pack, 128]`` bank table; ``pack`` banks share a
    physical word as ``32 / pack``-bit sub-words): the plain version of
    :func:`bloom_word_vmem`.  ``codes`` are read as unsigned 32-bit
    values; runs on any device."""
    N = (1 << log2_rows) // pack  # physical words per probe table
    sw = 32 // pack
    words_flat = table.reshape(-1)
    code_u = u32(codes)
    acc = None
    for p, salt in enumerate(salts):
        rows = mul32(code_u ^ salt, KNUTH) >> (32 - log2_rows)
        if pack > 1:
            lane = rows & 127
            bank = rows >> 7
            phys = (bank // pack) * 128 + lane
            got = u32(words_flat[p * N + phys])
            got = to_i32((got >> ((bank % pack) * sw)) & ((1 << sw) - 1))
        else:
            got = words_flat[p * N + rows]
        acc = got if acc is None else (acc & got)
    return acc


def _window_offsets(spc: int) -> int:
    """First word offset (relative to a cell's first word) covering the
    candidate windows ``[p - (s-1), p + l16)`` of the cell at byte ``p``."""
    s = 4 * spc
    return -((s - 1 + 3) // 4)


def _prefix_hash_select(get_plane, w, s, l16, c_min):
    """Rolling ``l16``-byte prefix hash of every cell's candidate window
    for the alignment named by the LOWEST set bit of ``w`` (0 when ``w``
    has none of its ``s`` alignment bits set).  ``get_plane(c)`` returns
    the corpus word at offset ``c`` from each cell's first word."""
    K = GRAM_BASE
    KL = pow(GRAM_BASE, l16 - 1, 1 << 32)
    byte_memo = {}

    def b(x):
        if x not in byte_memo:
            c, k = c_min + x // 4, x % 4
            byte_memo[x] = (u32(get_plane(c)) >> (8 * k)) & 0xFF
        return byte_memo[x]

    smask = (1 << s) - 1 if s < 32 else U32_MASK
    w8 = u32(w) & smask
    low = w8 & (-w8)  # lowest set bit as an unsigned value (0: none)
    off = -4 * c_min - (s - 1)  # window start byte of alignment s-1
    H = torch.zeros(w.shape, dtype=torch.int64, device=w.device)
    for i in range(l16):
        H = (H + b(off + i) * pow(GRAM_BASE, l16 - 1 - i, 1 << 32)) & U32_MASK
    h = torch.where(low == (1 << (s - 1)), H, 0)
    for j in range(s - 2, -1, -1):
        H = (mul32((H - b(off) * KL) & U32_MASK, K) + b(off + l16)) & U32_MASK
        off += 1
        h = torch.where(low == (1 << j), H, h)
    return to_i32(h)


def prefix_refine_words(w, ok, stride):
    """Zero the long word of a slot whose single coarse alignment bit
    failed the prefix probe; multi-bit slots pass unrefined (exactness
    never rests on a bloom)."""
    smask = (1 << stride) - 1 if stride < 32 else U32_MASK
    v = u32(w) & smask
    single = (v != 0) & ((v & (v - 1)) == 0)
    keep = torch.logical_not(single) | (ok == 1)
    return torch.where(keep, w, 0)


def _prefix_slot_ok(h_s, prefix_table, prefix_salts, prefix_log2):
    """AND over ``prefix_salts`` of each slot hash's bit in the prefix
    bit bloom."""
    words_flat = prefix_table.reshape(-1)
    ok = None
    for salt in prefix_salts:
        slot = mul32(u32(h_s) ^ salt, KNUTH) >> (32 - prefix_log2)
        word = words_flat[slot >> 5].to(torch.int64)
        bit = (word >> (slot & 31)) & 1
        ok = bit if ok is None else (ok & bit)
    return ok


def group_rank_extract(w, sw, hval, block_r, mpr, n_blocks, n_grid):
    """Survivor rank extraction per block column: slot ``k`` of column
    (block ``i``, lane ``l``) holds the (k+1)-th hit in row order at row
    ``i * mpr + k``.  Inputs are flat ``[n_blocks * block_r * 128]``;
    returns ``(r_s, w_s, swo_s, h_s, cnt)`` with ``r_s = -1`` and zeros in
    empty slots and ``cnt [n_blocks, 128]`` counting every hit."""
    dev = w.device
    tot = n_blocks * block_r * 128
    cell = torch.arange(tot, device=dev)
    hit = (((w | sw) != 0) & (cell < n_grid)).reshape(n_blocks, block_r, 128)
    hi = hit.to(torch.int32)
    cnt = hi.sum(dim=1, dtype=torch.int32)
    ranks = torch.cumsum(hi, dim=1)
    sel = hit & (ranks <= mpr)
    n_slots = n_blocks * mpr * 128
    blk_i = torch.arange(n_blocks, device=dev)[:, None, None]
    lane_i = torch.arange(128, device=dev)[None, None, :]
    row_i = torch.arange(block_r, device=dev, dtype=torch.int32)[None, :, None]
    # every selected cell owns a distinct slot; the rest all land in one
    # spare slot past the end, which is cut off (a fixed-shape scatter:
    # no host synchronisation)
    dst = torch.where(sel, (blk_i * mpr + ranks - 1) * 128 + lane_i, n_slots)

    def slots(fill, values):
        out = torch.full((n_slots + 1,), fill, dtype=torch.int32, device=dev)
        out.scatter_(0, dst.reshape(-1), values.reshape(-1))
        return out[:n_slots].reshape(n_blocks * mpr, 128)

    return (
        slots(-1, row_i.expand(n_blocks, block_r, 128)),
        slots(0, w),
        slots(0, sw),
        slots(0, hval),
        cnt,
    )


def _plane_torch(phase_g, c, spc, tot):
    """Word ``c`` (an offset from each cell's first word) of the first
    ``tot`` grid cells: phase ``c mod spc`` shifted by ``c div spc``
    cells, 0 before the corpus."""
    ph, d = c % spc, c // spc
    pf = phase_g[ph].reshape(-1)
    if d >= 0:
        return pf[d : d + tot]
    # the corpus has no bytes before offset 0
    return torch.cat(
        [torch.zeros(-d, dtype=pf.dtype, device=pf.device), pf[: tot + d]]
    )


def _fused_blocks(phase_g, mpr, block_r):
    """Blocks of ``block_r`` rows in the fused filter's grid; raises on an
    ``mpr`` that neither the kernel nor its plain version takes."""
    if mpr % 8 or not 8 <= mpr <= 128:
        raise ValueError(f"mpr={mpr}: must be a multiple of 8 in [8, 128]")
    return (phase_g.shape[1] - 8) // block_r


def _fused_extract_torch(
    table, phase_g, sw_g, mll, *, salts, log2_rows, pack, q, spc, mpr,
    block_r=FUSED_BLOCK_R, n_grid, l16=0, prefix_on=False,
    prefix_table=None, prefix_salts=(), prefix_log2=0,
):
    """Plain PyTorch version of the fused kernel (same plane, slot and
    hash semantics); runs on any device."""
    n_blocks = _fused_blocks(phase_g, mpr, block_r)
    tot = n_blocks * block_r * 128
    dev = table.device

    def get_plane(c):
        return _plane_torch(phase_g, c, spc, tot)

    code = torch.zeros(tot, dtype=torch.int64, device=dev)
    for j in range(q):
        j4, k = divmod(j, 4)
        byte = (u32(get_plane(j4)) >> (8 * k)) & 0xFF
        code = (code + byte * pow(GRAM_BASE, q - 1 - j, 1 << 32)) & U32_MASK
    w = _bank_probe_torch(table, code, salts, log2_rows, pack)
    w = torch.where(mll.reshape(()) > 0, w, 0)
    sw = sw_g.reshape(-1) if sw_g is not None else torch.zeros_like(w)
    if prefix_on:
        c_min = _window_offsets(spc)
        hval = _prefix_hash_select(get_plane, w, 4 * spc, l16, c_min)
    else:
        hval = to_i32(code)
    r_s, w_s, swo_s, h_s, cnt = group_rank_extract(
        w, sw, hval, block_r, mpr, n_blocks, n_grid
    )
    if prefix_table is not None and prefix_on:
        ok = _prefix_slot_ok(h_s, prefix_table, prefix_salts, prefix_log2)
        w_s = prefix_refine_words(w_s, ok, 4 * spc)
    return r_s, w_s, swo_s, h_s, cnt


def _check(name, t, shape, device, dtype=torch.int32):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _u32_array(values, n):
    arr = (ctypes.c_uint32 * n)()
    for i, v in enumerate(values):
        arr[i] = v & U32_MASK
    return arr


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: C signature of ``fused_sampled_extract_launch`` (csrc/*.cu)
_ARGTYPES = [
    _P, _LL,  # table, table words
    _P, _P, _P, _I,  # phases, word offsets, cell offsets, spc
    _P, _P, _LL, _P,  # sw, prefix table, prefix words, mll
    _P, _I, _I, _I,  # salts, k, log2_rows, pack
    _P, _I, _I, _I, _I,  # gram weight bytes, q, mpr, n_blocks, n_grid
    _P, _I, _I,  # prefix weights, l16, prefix_on
    _P, _I, _I,  # prefix salts, n prefix salts, prefix_log2
    _P, _P, _P, _P, _P,  # r_s, w_s, swo_s, h_s, cnt
    _P,  # stream
]
#: word offsets ``c`` the kernel reads: ``[-FUSED_OFF_BIAS, FUSED_OFF_BIAS)``
FUSED_OFF_BIAS = 8


@functools.lru_cache(maxsize=64)
def fused_word_offsets(spc: int, phase_words: int):
    """For every word offset ``c`` in ``[-8, 8)`` (index ``c + 8``): the
    flat offset into the ``[spc, phase_words]`` phases of word ``c`` of
    cell 0, ``(c mod spc) * phase_words + c div spc``, and its cell offset
    ``c div spc`` (floor division: the words before a cell's first lie in
    earlier cells).  The kernel reads word ``c`` of cell ``g`` at
    ``phases[woff[c + 8] + g]``, 0 where ``g + dcell[c + 8] < 0``."""
    woff, dcell = [], []
    for c in range(-FUSED_OFF_BIAS, FUSED_OFF_BIAS):
        ph, d = c % spc, c // spc
        woff.append(ph * phase_words + d)
        dcell.append(d)
    return tuple(woff), tuple(dcell)


@functools.lru_cache(maxsize=64)
def gram_weight_bytes(q: int, base: int = GRAM_BASE):
    """``[4][4]`` dp4a operands of the q-gram code: entry ``[c][m]`` packs
    byte ``m`` of the weights ``base^(q-1-j)`` of the bytes ``j = 4c ..
    4c+3`` of word ``c`` (0 past ``q``), so that the code is ``sum_m
    2^(8m) sum_c dp4a(word_c, gb[c][m])`` mod 2^32."""
    w = [pow(base, q - 1 - j, 1 << 32) if j < q else 0
         for j in range(16)]
    return tuple(tuple(sum(((w[4 * c + k] >> (8 * m)) & 0xFF) << (8 * k)
                           for k in range(4)) for m in range(4))
                 for c in range(4))


@functools.lru_cache(maxsize=64)
def _launch_consts(spc, phase_words, q, l16, salts, prefix_salts):
    """The fused kernel's per-configuration ctypes arrays, built once."""
    woff, dcell = fused_word_offsets(spc, phase_words)
    gram_b = [v for row in gram_weight_bytes(q) for v in row]
    pref_w = [pow(GRAM_BASE, l16 - 1 - i, 1 << 32) for i in range(l16)]
    return (
        (ctypes.c_longlong * len(woff))(*woff),
        (ctypes.c_int * len(dcell))(*dcell),
        _u32_array(salts, len(salts)), _u32_array(gram_b, 16),
        _u32_array(pref_w, max(l16, 1)),
        _u32_array(prefix_salts, max(len(prefix_salts), 1)),
    )


def fused_launch_shape(q: int, table_bytes: int, n_blocks: int) -> dict:
    """Grid, block and resident blocks per SM of the fused kernel's launch
    on the current CUDA device (launches nothing)."""
    return fused_sampled_extract.launch_shape(
        "fused_sampled_extract_shape", [_I, _LL, _I, _P, _P, _P], q,
        table_bytes, n_blocks)


@hand_kernel(plain=_fused_extract_torch)
def fused_sampled_extract(
    kernel,
    table: torch.Tensor,  # [k * n_banks / pack, 128] int32 bank rows
    phase_g: torch.Tensor,  # [spc, R_pad + 8, 128] int32 word phases
    sw_g: Optional[torch.Tensor],  # [R_pad, 128] int32 short words
    mll: torch.Tensor,  # [1, 1] int32 min_long_len
    *,
    salts: tuple,
    log2_rows: int,
    pack: int,
    q: int,
    spc: int,  # corpus words per grid cell (stride // 4)
    mpr: int,  # slots per block column (multiple of 8, <= 128)
    block_r: int = FUSED_BLOCK_R,
    n_grid: int,  # valid cells (B * M); the rest is padding
    l16: int = 0,  # prefix-hash window bytes
    prefix_on: bool = False,
    prefix_table: Optional[torch.Tensor] = None,  # [pb_rows, 128] int32
    prefix_salts: tuple = (),
    prefix_log2: int = 0,
) -> Tuple[torch.Tensor, ...]:
    """Fused codes + probe + rank-extract.  Returns ``(r_s, w_s, swo_s,
    h_s, cnt)``: slot arrays ``[n_blocks * mpr, 128]`` (block ``i``'s
    slots at rows ``[i*mpr, (i+1)*mpr)``; ``r_s`` = row within the block,
    -1 when empty) and ``cnt [n_blocks, 128]`` the per-column survivor
    counts (``max(cnt) > mpr`` means slots were dropped: retry with a
    bigger ``mpr``).  ``h_s`` is the slot's prefix-window hash when
    ``prefix_on``, else its q-gram code.

    A CUDA ``table`` launches the Hopper kernel (counted in
    ``fused_sampled_extract.launches``); a CPU one runs the plain
    version."""
    n_blocks = _fused_blocks(phase_g, mpr, block_r)
    R_pad = phase_g.shape[1] - 8
    dev = table.device
    n_banks = (1 << log2_rows) // 128
    if block_r != FUSED_BLOCK_R or R_pad % FUSED_BLOCK_R:
        raise ValueError(f"the CUDA kernel takes block_r={FUSED_BLOCK_R} only")
    if not (1 <= len(salts) <= 8 and pack in (1, 2, 4)
            and 7 <= log2_rows <= 31 and n_banks % pack == 0 and 1 <= q <= 16
            and 1 <= spc <= 8 and 0 <= l16 <= 20
            and len(prefix_salts) <= 2 and n_grid <= R_pad * 128):
        raise ValueError("fused_sampled_extract: unsupported configuration")
    _check("table", table, (len(salts) * n_banks // pack, 128), dev)
    _check("phase_g", phase_g, (spc, R_pad + 8, 128), dev)
    if sw_g is not None:
        _check("sw_g", sw_g, (R_pad, 128), dev)
    _check("mll", mll, (1, 1), dev)
    if prefix_table is not None:
        _check("prefix_table", prefix_table, (prefix_table.shape[0], 128),
               dev)
        if not 5 <= prefix_log2 <= 31 or (
            prefix_table.numel() * 32 != 1 << prefix_log2
        ):
            raise ValueError("prefix_table size must be 2**prefix_log2 bits")
    out_shape = (n_blocks * mpr, 128)
    r_s, w_s, swo_s, h_s = (torch.empty(out_shape, dtype=torch.int32,
                                        device=dev) for _ in range(4))
    cnt = torch.empty((n_blocks, 128), dtype=torch.int32, device=dev)
    woff, dcell, salts_a, gram_b, pref_w, psalts_a = _launch_consts(
        spc, phase_g.shape[1] * 128, q, l16, tuple(salts),
        tuple(prefix_salts))
    kernel.launch(
        kernel.entry_point("fused_sampled_extract_launch", _ARGTYPES), dev,
        table.data_ptr(), table.numel(), phase_g.data_ptr(), woff, dcell,
        spc,
        sw_g.data_ptr() if sw_g is not None else None,
        prefix_table.data_ptr() if prefix_table is not None else None,
        prefix_table.numel() if prefix_table is not None else 0,
        mll.data_ptr(),
        salts_a, len(salts), log2_rows, pack, gram_b, q, mpr, n_blocks,
        n_grid, pref_w, l16, int(bool(prefix_on)), psalts_a,
        len(prefix_salts), prefix_log2,
        r_s.data_ptr(), w_s.data_ptr(), swo_s.data_ptr(), h_s.data_ptr(),
        cnt.data_ptr(),
    )
    return r_s, w_s, swo_s, h_s, cnt


def _out_like(codes: torch.Tensor) -> torch.Tensor:
    """An empty int32 tensor of ``codes``' shape whose address lies at the
    same offset within 16 bytes as ``codes``' (the kernel streams both
    through 16-byte loads and stores, with the same head before the first
    16-byte boundary)."""
    n = codes.numel()
    buf = torch.empty(n + 3, dtype=torch.int32, device=codes.device)
    lead = (codes.data_ptr() - buf.data_ptr()) % 16 // 4
    return buf[lead : lead + n].view(codes.shape)


#: C signatures of ``csrc/bloom_word_vmem.cu``'s entry points
BLOOM_WORD_VMEM_ARGTYPES = {
    # table, table words, codes, out, n, salts, k, log2_rows, pack, stream
    "bloom_word_vmem_launch": [_P, _LL, _P, _P, _LL, _P, _I, _I, _I, _P],
    # table words, pack, n, grid, block, blocks per SM
    "bloom_word_vmem_shape": [_LL, _I, _LL, _P, _P, _P],
}


def bloom_word_vmem_launch_shape(table_words: int, pack: int, n: int) -> dict:
    """Grid, block and resident blocks per SM of ``bloom_word_vmem``'s
    launch for ``n`` codes on the current CUDA device (launches
    nothing)."""
    name = "bloom_word_vmem_shape"
    return bloom_word_vmem.launch_shape(
        name, BLOOM_WORD_VMEM_ARGTYPES[name], table_words, pack, n)


@hand_kernel(plain=_bank_probe_torch)
def bloom_word_vmem(
    kernel,
    table: torch.Tensor,  # [k * n_banks / pack, 128] int32 bank rows
    codes: torch.Tensor,  # [...] int32 gram codes
    salts: tuple,  # k probe salts, one bank table each
    log2_rows: int,  # log2 of the words of one (unpacked) probe table
    pack: int = 1,  # banks per physical word (32/pack-bit sub-words)
) -> torch.Tensor:
    """AND over ``salts`` of each code's salted bank-bloom sub-word; same
    shape as ``codes``, int32.  A zero word means no alignment of any long
    pattern can produce the gram.

    A CUDA ``table`` launches ``csrc/bloom_word_vmem.cu`` (counted in
    ``bloom_word_vmem.launches``); a CPU one runs
    :func:`_bank_probe_torch`.  On the card the result lies at the same
    offset within 16 bytes as ``codes`` (:func:`_out_like`)."""
    dev = table.device
    n_banks = (1 << log2_rows) // 128
    if not (1 <= len(salts) <= 8 and pack in (1, 2, 4)
            and 7 <= log2_rows <= 31 and n_banks % pack == 0):
        raise ValueError("bloom_word_vmem: unsupported configuration")
    _check("table", table, (len(salts) * n_banks // pack, 128), dev)
    _check("codes", codes, codes.shape, dev)
    out = _out_like(codes)
    if codes.numel() == 0:
        return out
    name = "bloom_word_vmem_launch"
    kernel.launch(
        kernel.entry_point(name, BLOOM_WORD_VMEM_ARGTYPES[name]), dev,
        table.data_ptr(), table.numel(), codes.data_ptr(), out.data_ptr(),
        codes.numel(), _u32_array(salts, len(salts)), len(salts), log2_rows,
        pack,
    )
    return out


#: C signature of ``bloom_hit_launch`` (csrc/bloom_hit.cu): words, their
#: count, slots, out, n, stream
BLOOM_HIT_ARGTYPES = [_P, _LL, _P, _P, _LL, _P]


@hand_kernel(plain=bloom_hit_take)
def bloom_hit(kernel, words: torch.Tensor,
              slots: torch.Tensor) -> torch.Tensor:
    """Bit ``slot`` of the bit bloom ``words [W]`` for every slot in
    ``[0, 32 * W)``, as int32 0/1 of the slots' shape.

    A CUDA ``words`` launches ``csrc/bloom_hit.cu`` (counted in
    ``bloom_hit.launches``); a CPU one runs
    ``filter_torch.bloom_hit_take``."""
    dev = words.device
    _check("words", words, (words.shape[0],), dev)
    _check("slots", slots, slots.shape, dev)
    out = torch.empty_like(slots)
    if slots.numel() == 0:
        return out
    kernel.launch(kernel.entry_point("bloom_hit_launch", BLOOM_HIT_ARGTYPES),
                  dev, words.data_ptr(), words.numel(), slots.data_ptr(),
                  out.data_ptr(), slots.numel())
    return out


def grouped_blocks(n_grid: int, block_r: int) -> int:
    """Extraction groups of the grouped take filter: ``block_r`` rows of
    128 cells each, at least one."""
    return max(1, -(-(-(-n_grid // 128)) // block_r))


def _grouped_extract_torch(words, wc, sw, mll, words2=None, *, q, spc,
                           log2_words, salts, mpr, block_r):
    """Plain PyTorch version of :func:`grouped_take_extract` (stage A,
    rank extraction and stage B1 of the grouped take filter); runs on any
    device."""
    B = wc.shape[0]
    M = wc.shape[1] // spc
    n_grid = B * M
    planes = _word_planes(wc, q, spc)
    code_u = _planes_code(planes, q, GRAM_BASE)
    # stage A: the first salt only, over the grid
    w = _salted_probe(words, code_u, salts[0], log2_words).reshape(-1)
    w = torch.where(mll.reshape(()) > 0, w, 0)
    sw = sw.reshape(-1) if sw is not None else torch.zeros_like(w)
    n_blocks = grouped_blocks(n_grid, block_r)
    tot = n_blocks * block_r * 128

    def pad_flat(x):
        return torch.cat([x.reshape(-1), x.new_zeros(tot - n_grid)])

    # with a second-family bloom the slot carries the GRAM_BASE2 code
    # (its probe replaces the same-code second salt, which a true code
    # collision would always pass)
    hv = (_planes_code(planes, q, GRAM_BASE2) if words2 is not None
          else code_u)
    r_s, w_s, swo_s, c_s, cnt = group_rank_extract(
        pad_flat(w), pad_flat(sw), pad_flat(to_i32(hv)), block_r, mpr,
        n_blocks, n_grid,
    )
    # stage B1: per-slot re-probes
    c_u = u32(c_s)
    if words2 is not None:
        w_s = w_s & _salted_probe(words2, c_u, SALT2, log2_words)
    else:
        for salt in salts[1:]:
            w_s = w_s & _salted_probe(words, c_u, salt, log2_words)
    return r_s, w_s, swo_s, c_s, cnt


def _grouped_refine_torch(slot, r_s, w_s, swo_s, wc, prefix_words=None, *,
                          mpr, block_r, spc, prefix_salts=(), prefix_log2=0,
                          prefix_len=0):
    """Plain PyTorch version of :func:`grouped_take_refine` (stage B2 of
    the grouped take filter); runs on any device."""
    dev = r_s.device
    nrows = r_s.shape[0]
    blk = (torch.arange(nrows, dtype=torch.int32, device=dev) // mpr)[:, None]
    lane = torch.arange(128, dtype=torch.int32, device=dev)[None, :]
    cell_s = (blk * block_r + r_s) * 128 + lane
    safe = torch.clamp(slot, max=nrows * 128 - 1).long()
    valid = slot < INT32_MAX
    idx = torch.where(valid, cell_s.reshape(-1)[safe], INT32_MAX)
    lw = torch.where(valid, w_s.reshape(-1)[safe], 0)
    swo = torch.where(valid, swo_s.reshape(-1)[safe], 0)
    if prefix_words is None:
        return idx, lw, swo
    stride = 4 * spc
    wc_flat = wc.reshape(-1)
    first_word = torch.where(valid, idx, 0).long() * spc
    plane_memo = {}

    def get_plane(c):
        # clamped to the flat pack: a window reads across rows
        if c not in plane_memo:
            widx = torch.clamp(first_word + c, 0, wc_flat.shape[0] - 1)
            plane_memo[c] = wc_flat[widx]
        return plane_memo[c]

    h_s = _prefix_hash_select(get_plane, lw, stride, prefix_len,
                              _window_offsets(spc))
    ok = None
    for salt in prefix_salts:
        bit = bloom_hit_take(prefix_words, bloom_slots(h_s, prefix_log2, salt))
        ok = bit if ok is None else (ok & bit)
    # a long word survives unless its single alignment failed the probe
    # (alignment bits taken unsigned: bit 31 at stride 32 too)
    keep = (prefix_refine_words(lw, ok, stride) != 0) | (swo != 0)
    return (torch.where(keep, idx, INT32_MAX), torch.where(keep, lw, 0),
            torch.where(keep, swo, 0))


#: C signatures of the grouped take filter's entry points (csrc/*.cu)
GROUPED_ARGTYPES = {
    "grouped_take_extract_launch": [
        _P, _LL, _I, _I,  # wc, words a row, spc, cells a row (M)
        _P, _I, _P, _I,  # words, log2_words, salts, k
        _P, _P, _P,  # words2, sw, mll
        _P, _P, _I,  # gram weight bytes, second family's, q
        _I, _I, _I, _I,  # mpr, block_r, n_blocks, n_grid
        _P, _P, _P, _P, _P,  # r_s, w_s, swo_s, c_s, cnt
        _P,  # stream
    ],
    "grouped_take_refine_launch": [
        _P, _LL,  # slot, n
        _P, _P, _P, _LL,  # r_s, w_s, swo_s, slot cells
        _I, _I, _I,  # mpr, block_r, spc
        _P, _LL,  # wc, corpus words
        _P, _P, _I, _I,  # prefix words, prefix salts, n salts, prefix_log2
        _P, _I,  # prefix weights, prefix_len
        _P, _P, _P,  # idx, lw, swo
        _P,  # stream
    ],
}


@functools.lru_cache(maxsize=64)
def _extract_consts(q, salts):
    gram_b = [v for row in gram_weight_bytes(q) for v in row]
    gram_b2 = [v for row in gram_weight_bytes(q, GRAM_BASE2) for v in row]
    return (_u32_array(salts, len(salts)), _u32_array(gram_b, 16),
            _u32_array(gram_b2, 16))


@hand_kernel(plain=_grouped_extract_torch)
def grouped_take_extract(
    kernel,
    words: torch.Tensor,  # [2**log2_words] int32 positional bloom
    wc: torch.Tensor,  # [B, M * spc] int32 packed corpus words
    sw: Optional[torch.Tensor],  # [B, M] int32 short-start words, or None
    mll: torch.Tensor,  # scalar int32 min_long_len (0: no long path)
    words2: Optional[torch.Tensor] = None,  # second-family bloom, or None
    *,
    q: int,
    spc: int,  # corpus words per grid cell (stride // 4)
    log2_words: int,
    salts: tuple,
    mpr: int,  # slots per group column, <= 128
    block_r: int,  # rows of 128 cells per extraction group
) -> Tuple[torch.Tensor, ...]:
    """The grouped take filter's grid stage.  Every grid cell's q-gram
    code (``GRAM_BASE``, from its row's words; zeros past the row) probes
    the positional bloom under the first salt, gated on ``mll``; a cell
    hits where that word or its short word is nonzero.  The hits of each
    (group ``i``, lane ``l``) column are rank-extracted: slot ``k`` (row
    ``i * mpr + k`` of the ``[n_blocks * mpr, 128]`` slot arrays) holds the
    ``(k+1)``-th hit in row order.  Each extracted long word is then ANDed
    with the remaining salts' words, or, with ``words2``, with the
    ``GRAM_BASE2`` code's word under ``SALT2``.  Returns ``(r_s, w_s,
    swo_s, c_s, cnt)``: the hit's row in its group (-1 and zeros in an
    empty slot), its long and short words, its code (the ``GRAM_BASE2``
    one with ``words2``) and the hits of each column ``[n_blocks, 128]``.

    A CUDA ``words`` launches ``csrc/grouped_take_extract.cu`` (counted in
    ``grouped_take_extract.launches``); a CPU one runs
    :func:`_grouped_extract_torch`."""
    dev = words.device
    B = wc.shape[0]
    M = wc.shape[1] // spc
    n_grid = B * M
    n_blocks = grouped_blocks(n_grid, block_r)
    if not (1 <= len(salts) <= 8 and 1 <= q <= 16 and 1 <= spc <= 8
            and 5 <= log2_words <= 31 and 1 <= mpr <= 128
            and 1 <= block_r <= 1024 and wc.shape[1] == M * spc
            and n_blocks * block_r * 128 < 2**31):
        raise ValueError("grouped_take_extract: unsupported configuration")
    _check("words", words, (1 << log2_words,), dev)
    _check("wc", wc, wc.shape, dev)
    if wc.dim() != 2:
        raise ValueError("wc: expected [B, M * spc]")
    if sw is not None:
        _check("sw", sw, (B, M), dev)
    if words2 is not None:
        _check("words2", words2, (1 << log2_words,), dev)
    _check("mll", mll, mll.shape, dev)
    if mll.numel() != 1:
        raise ValueError("mll: expected one value")
    slots = (n_blocks * mpr, 128)
    r_s, w_s, swo_s, c_s = (
        torch.empty(slots, dtype=torch.int32, device=dev) for _ in range(4))
    cnt = torch.empty((n_blocks, 128), dtype=torch.int32, device=dev)
    salts_a, gram_b, gram_b2 = _extract_consts(q, tuple(salts))
    name = "grouped_take_extract_launch"
    kernel.launch(
        kernel.entry_point(name, GROUPED_ARGTYPES[name]), dev,
        wc.data_ptr(), wc.shape[1], spc, M,
        words.data_ptr(), log2_words, salts_a, len(salts),
        words2.data_ptr() if words2 is not None else None,
        sw.data_ptr() if sw is not None else None, mll.data_ptr(),
        gram_b, gram_b2, q, mpr, block_r, n_blocks, n_grid,
        r_s.data_ptr(), w_s.data_ptr(), swo_s.data_ptr(), c_s.data_ptr(),
        cnt.data_ptr(),
    )
    return r_s, w_s, swo_s, c_s, cnt


@functools.lru_cache(maxsize=64)
def _refine_consts(prefix_len, prefix_salts):
    pref_w = [pow(GRAM_BASE, prefix_len - 1 - i, 1 << 32)
              for i in range(prefix_len)]
    return (_u32_array(prefix_salts, max(len(prefix_salts), 1)),
            _u32_array(pref_w, max(prefix_len, 1)))


@hand_kernel(plain=_grouped_refine_torch)
def grouped_take_refine(
    kernel,
    slot: torch.Tensor,  # [capacity] int32 slot numbers, INT32_MAX: none
    r_s: torch.Tensor,  # [n_blocks * mpr, 128] int32 slot arrays
    w_s: torch.Tensor,
    swo_s: torch.Tensor,
    wc: torch.Tensor,  # [B, M * spc] int32 packed corpus words
    prefix_words: Optional[torch.Tensor] = None,  # bit bloom; None: off
    *,
    mpr: int,
    block_r: int,
    spc: int,
    prefix_salts: tuple = (),
    prefix_log2: int = 0,
    prefix_len: int = 0,
) -> Tuple[torch.Tensor, ...]:
    """The grouped take filter's refinement of its compacted hits, in slot
    order.  Each entry gathers its slot's grid cell, long and short word
    (``INT32_MAX`` and zeros where ``slot`` is ``INT32_MAX``).  With
    ``prefix_words``, a long word naming a single alignment keeps it only
    if the ``prefix_len``-byte polynomial hash of that alignment's window
    (corpus words read from the flat pack, clamped to its ends) has its
    bit set in the prefix bit bloom under every salt; an entry left with
    neither word becomes ``INT32_MAX`` with zeros.  Returns ``(idx, lw,
    swo)``.

    A CUDA ``slot`` launches ``csrc/grouped_take_refine.cu`` (counted in
    ``grouped_take_refine.launches``); a CPU one runs
    :func:`_grouped_refine_torch`."""
    dev = slot.device
    prefix_on = prefix_words is not None
    if not (1 <= mpr <= 128 and 1 <= block_r <= 1024 and 1 <= spc <= 8
            and r_s.shape[0] % mpr == 0
            and (not prefix_on or (1 <= len(prefix_salts) <= 8
                                   and 5 <= prefix_log2 <= 31
                                   and 1 <= prefix_len <= 20))):
        raise ValueError("grouped_take_refine: unsupported configuration")
    _check("slot", slot, (slot.shape[0],), dev)
    for name, t in (("r_s", r_s), ("w_s", w_s), ("swo_s", swo_s)):
        _check(name, t, (r_s.shape[0], 128), dev)
    _check("wc", wc, wc.shape, dev)
    if prefix_on:
        _check("prefix_words", prefix_words, (1 << prefix_log2 >> 5,), dev)
    idx, lw, swo = (torch.empty_like(slot) for _ in range(3))
    if slot.numel() == 0:
        return idx, lw, swo
    psalts_a, pref_w = _refine_consts(prefix_len if prefix_on else 0,
                                      tuple(prefix_salts) if prefix_on
                                      else ())
    name = "grouped_take_refine_launch"
    kernel.launch(
        kernel.entry_point(name, GROUPED_ARGTYPES[name]), dev,
        slot.data_ptr(), slot.numel(), r_s.data_ptr(), w_s.data_ptr(),
        swo_s.data_ptr(), r_s.numel(), mpr, block_r, spc,
        wc.data_ptr(), wc.numel(),
        prefix_words.data_ptr() if prefix_on else None, psalts_a,
        len(prefix_salts) if prefix_on else 0, prefix_log2 if prefix_on else 0,
        pref_w, prefix_len if prefix_on else 0,
        idx.data_ptr(), lw.data_ptr(), swo.data_ptr(),
    )
    return idx, lw, swo


#: C signature of ``flat_take_extract_launch`` (csrc/flat_take_extract.cu)
FLAT_ARGTYPES = [
    _P, _LL, _I,  # chunks, rows, row_len
    _P, _I, _P, _I,  # words, log2_words, salts, k
    _P, _P, _P,  # sw, mll, gram weight bytes
    _I, _I, _I,  # q, stride, capacity
    _P, _P,  # scratch, n_hits
    _P, _P, _P,  # idx, lw, swo
    _P,  # stream
]


@functools.lru_cache(maxsize=64)
def _flat_consts(q, salts):
    gram_b = [v for row in gram_weight_bytes(q) for v in row]
    return _u32_array(salts, len(salts)), _u32_array(gram_b, 16)


def check_flat_inputs(words, chunks, sw, mll, *, q, stride, log2_words,
                      salts, capacity):
    """Raise on what ``csrc/flat_take_extract.cu`` does not take: q 1-16,
    1-8 salts, stride 1-32, ``log2_words`` 5-31, ``capacity`` >= 1, a grid
    under 2^31 cells; every tensor on ``words``' device and contiguous,
    ``words`` int32 ``[2**log2_words]``, ``chunks`` uint8 ``[B, L]``,
    ``sw`` None or int32 ``[B, ceil(L / stride)]``, ``mll`` one int32."""
    if not (1 <= q <= 16 and 1 <= len(salts) <= 8 and 1 <= stride <= 32
            and 5 <= log2_words <= 31 and capacity >= 1):
        raise ValueError("flat_take_extract: unsupported configuration")
    dev = words.device
    _check("words", words, (1 << log2_words,), dev)
    if chunks.dim() != 2:
        raise ValueError("chunks: expected [B, L]")
    B, L = chunks.shape
    M = -(-L // stride)
    if B * M >= 2**31 - 2**15:
        raise ValueError("flat_take_extract: grid of 2^31 cells or more")
    _check("chunks", chunks, (B, L), dev, torch.uint8)
    if sw is not None:
        _check("sw", sw, (B, M), dev)
    _check("mll", mll, mll.shape, dev)
    if mll.numel() != 1:
        raise ValueError("mll: expected one value")


@hand_kernel(plain=_flat_extract_torch)
def flat_take_extract(
    kernel,
    words: torch.Tensor,  # [2**log2_words] int32 positional bloom
    chunks: torch.Tensor,  # [B, L] uint8
    sw: Optional[torch.Tensor],  # [B, M] int32 short-start words, or None
    mll: torch.Tensor,  # scalar int32 min_long_len (0: no long path)
    *,
    q: int,
    stride: int,
    log2_words: int,
    salts: tuple,
    capacity: int,
) -> Tuple[torch.Tensor, ...]:
    """The flat take filter's grid work and compaction.  Every grid cell
    ``g = b * M + m`` (``M = ceil(L / stride)``) takes the ``GRAM_BASE``
    code of its row's bytes ``m * stride .. + q`` (zeros past the row) and
    ANDs its positional-bloom words under every salt, gated on ``mll``;
    it hits where that word or its short word is nonzero.  The first
    ``capacity`` hits in ascending ``g`` are kept.  Returns ``(idx
    [capacity], long_word, short_word, n_hits)``: the hits' cells
    (``INT32_MAX`` after them), their words (0 after them), and the count
    of every hit.

    A CUDA ``words`` launches ``csrc/flat_take_extract.cu`` (counted in
    ``flat_take_extract.launches``), after :func:`check_flat_inputs`; a
    CPU one runs ``filter_torch._flat_extract_torch``."""
    check_flat_inputs(words, chunks, sw, mll, q=q, stride=stride,
                      log2_words=log2_words, salts=salts, capacity=capacity)
    dev = words.device
    B, L = chunks.shape
    scratch_words = kernel.entry_point("flat_take_extract_scratch_words",
                                       [_LL, _I], _LL)
    scratch = torch.empty(scratch_words(B * -(-L // stride), stride),
                          dtype=torch.int32, device=dev)
    idx, lw, swo = (torch.empty(capacity, dtype=torch.int32, device=dev)
                    for _ in range(3))
    n_hits = torch.empty((), dtype=torch.int32, device=dev)
    salts_a, gram_b = _flat_consts(q, tuple(salts))
    kernel.launch(
        kernel.entry_point("flat_take_extract_launch", FLAT_ARGTYPES), dev,
        chunks.data_ptr(), B, L, words.data_ptr(), log2_words, salts_a,
        len(salts), sw.data_ptr() if sw is not None else None,
        mll.data_ptr(), gram_b, q, stride, capacity, scratch.data_ptr(),
        n_hits.data_ptr(), idx.data_ptr(), lw.data_ptr(), swo.data_ptr(),
    )
    return idx, lw, swo, n_hits


#: C signature of ``verify_records_launch`` (csrc/verify_records.cu)
VERIFY_ARGTYPES = [
    _P, _I, _I,  # table, its entry bytes, step
    _P,  # byte_class
    _P, _LL, _I,  # chunks, rows, row_len
    _P, _P, _P, _P,  # lengths, emit_from, grid_idx, final_start
    _I, _I, _I, _I, _I,  # n_classes, stride, win_len, H, capacity
    _P, _P, _P, _P,  # scratch, rec_cell, rec_pack, n_rec
    _P,  # stream
]


def check_verify_inputs(table, byte_class, chunks, lengths, emit_from,
                        grid_idx, final_start, *, n_classes, stride,
                        win_len, capacity, step):
    """Raise on what ``csrc/verify_records.cu`` does not take: every
    tensor on ``table``'s device and contiguous, ``table`` 1-D int16 or
    int32 (int32 for the 2-step table), ``byte_class`` int32 ``[256]``,
    ``chunks`` uint8 ``[B, L]``, ``lengths``, ``emit_from`` int32 ``[B]``,
    ``grid_idx`` 1-D int32, ``final_start`` one int32; ``win_len`` 1-31,
    ``step`` 1 or 2."""
    if not (step in (1, 2) and 1 <= win_len <= 31 and stride >= 1
            and n_classes >= 1 and capacity >= 1):
        raise ValueError("verify_records: unsupported configuration")
    dev = table.device
    dtypes = (torch.int16, torch.int32) if step == 1 else (torch.int32,)
    if table.dtype not in dtypes:
        raise TypeError(f"table: expected one of {dtypes} for step {step}, "
                        f"got {table.dtype}")
    _check("table", table, (table.numel(),), dev, table.dtype)
    _check("byte_class", byte_class, (256,), dev)
    if chunks.dim() != 2 or chunks.numel() == 0:
        raise ValueError("chunks: expected a non-empty [B, L]")
    B, L = chunks.shape
    _check("chunks", chunks, (B, L), dev, torch.uint8)
    _check("lengths", lengths, (B,), dev)
    _check("emit_from", emit_from, (B,), dev)
    _check("grid_idx", grid_idx, (grid_idx.numel(),), dev)
    _check("final_start", final_start, final_start.shape, dev)
    if final_start.numel() != 1:
        raise ValueError("final_start: expected one value")


@hand_kernel(plain=_verify_records_torch)
def verify_records(
    kernel,
    table: torch.Tensor,  # dense [S*C] int16/int32, or 2-step [S*C*C] int32
    byte_class: torch.Tensor,  # [256] int32
    used_bytes: torch.Tensor,  # uint8, read by the plain version only
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
    step: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The records verify of ``filter_torch.verify_windows_records``
    (``step`` 1, the dense table) or ``verify_windows_records2`` (``step``
    2, the packed 2-step table): each of the first ``min(n_hits,
    len(grid_idx))`` hit slots walks its window and keeps its records,
    which are compacted in slot-major order.  Returns ``(rec_cell [cap],
    rec_pack [cap], n_rec)``.

    A CUDA ``table`` launches ``csrc/verify_records.cu`` (counted in
    ``verify_records.launches``), after :func:`check_verify_inputs`; it
    classifies through ``byte_class`` alone, which the automaton builds
    from ``used_bytes``.  A CPU one runs
    ``filter_torch._verify_records_torch``."""
    check_verify_inputs(
        table, byte_class, chunks, lengths, emit_from, grid_idx, final_start,
        n_classes=n_classes, stride=stride, win_len=win_len,
        capacity=capacity, step=step)
    H = min(n_hits, grid_idx.shape[0])
    if H < 1:
        raise ValueError("verify_records: no hit slots")
    dev = table.device
    scratch_words = kernel.entry_point("verify_records_scratch_words",
                                       [_LL], _LL)
    scratch = torch.empty(scratch_words(H), dtype=torch.int32, device=dev)
    rec_cell = torch.empty(capacity, dtype=torch.int32, device=dev)
    rec_pack = torch.empty(capacity, dtype=torch.int32, device=dev)
    n_rec = torch.empty((), dtype=torch.int32, device=dev)
    B, L = chunks.shape
    kernel.launch(
        kernel.entry_point("verify_records_launch", VERIFY_ARGTYPES), dev,
        table.data_ptr(), table.element_size(), step, byte_class.data_ptr(),
        chunks.data_ptr(), B, L, lengths.data_ptr(), emit_from.data_ptr(),
        grid_idx.data_ptr(), final_start.data_ptr(), n_classes, stride,
        win_len, H, capacity, scratch.data_ptr(), rec_cell.data_ptr(),
        rec_pack.data_ptr(), n_rec.data_ptr(),
    )
    return rec_cell, rec_pack, n_rec
