"""Gram-filter cascade model — planning and host-side exact verification.

See ops/filter_torch.py for the device chain.  This module decides when the
cascade applies, builds the per-stage hashed blooms from the pattern set,
and serves a scan by one of three routes (:meth:`CascadeModel.run_arrays`):
sampled plans whose windows fit 31 bytes emit match records from the
device; sampled plans whose windows fit 32 bytes but not the records
gate flag matching windows on the device and re-walk them on the host;
the anchored plan and sampled plans with longer windows fetch candidate
starts and verify them exactly on the host with a vectorized trie walk
(goto-only, detected via ``state_depth``).  The device walks run on the
dense table or, for signature-scale sets, the compressed one.

The start-based paradigm is the "failure-less Aho-Corasick" family
(cf. PFAC, arXiv:1811.10498, PAPERS.md) — here with a vectorized bloom
prefilter in front so only candidate starts pay the walk.

Equivalence argument (vs the DFA scan): every occurrence of every pattern
is found at its own start position — a pattern that is a suffix factor of
another match (the reference's failure-chain emission,
``node_collect_matches``) starts at a later position and is detected
there independently.  Sorting verified (start, pattern) pairs by
``(end, start)`` reproduces the reference's emission order exactly:
ascending end position, and within one end the longest pattern (earliest
start) first (``tests/test1.phpt:99-118``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .. import native
from ..config import ScanConfig
from ..core.tables import CompiledAutomaton
from ..ops.filter_torch import GRAM_BASE, KNUTH
from ..ops.matches import PackedRows
from ..utils import next_pow2 as _next_pow2


def _next_cap(n: int) -> int:
    """Smallest of ``{1, 1.25, 1.5, 1.75} * 2**k`` >= n: capacity sizing
    at quarter-octave granularity.  Device verify/compaction cost is
    capacity-proportional, so pure pow2 rounding wastes up to 2x work
    right after a threshold (66k matches -> 131072 slots; quarter steps
    give 81920).  Each distinct capacity is one extra compile per
    workload scale (persistent-cached)."""
    n = max(int(n), 1)
    p = 1
    while p < n:
        p *= 2
    for frac in (4, 5, 6, 7):
        c = frac * p // 8
        if c >= n:
            return c
    return p


@dataclasses.dataclass
class CascadePlan:
    eligible: bool
    reason: str
    q: int = 0
    offsets: Tuple[int, ...] = ()
    salts: Tuple[int, ...] = ()
    log2_bits: int = 0
    bloom_words: Optional[np.ndarray] = None  # [n_stages, bits/32] int32
    shorts: Tuple[bytes, ...] = ()
    min_long_len: int = 0
    #: own pattern id per state (-1 when the state's string is no pattern)
    own_pat: Optional[np.ndarray] = None
    #: "anchored": per-position multi-stage blooms; "sampled": one
    #: positional-alignment bloom checked every ``stride`` positions
    mode: str = "anchored"
    stride: int = 0
    log2_words: int = 0
    sampled_salts: Tuple[int, ...] = ()
    sampled_words: Optional[np.ndarray] = None  # [2**log2_words] int32
    #: second-code-family positional bloom (signature scale): built when
    #: the entry count makes 32-bit code collisions non-negligible; the
    #: grouped take path probes it with GRAM_BASE2 codes on extracted
    #: slots (the JAX package's ops/filter_jax.GRAM_BASE2)
    sampled_words2: Optional[np.ndarray] = None  # [2**log2_words] int32
    #: planner's estimated candidate starts per scanned byte (diagnostics)
    est_cand_density: float = 0.0
    #: lane-partitioned VMEM bloom (Pallas fast path; None when the pattern
    #: set saturates the VMEM-sized table): [2**vmem_log2_rows] int32 words
    #: probed under len(vmem_salts) hashes (ops/filter_pallas.bloom_word_vmem)
    vmem_log2_rows: int = 0
    vmem_salts: Tuple[int, ...] = ()
    vmem_words: Optional[np.ndarray] = None
    #: banks packed per physical int32 row (32 // subword width; a
    #: positional word only needs ``stride`` alignment bits)
    vmem_pack: int = 1
    #: planner's per-cell stray-hit estimate for the VMEM bloom (diagnostics)
    vmem_est_stray: float = 0.0
    #: pattern-prefix bit bloom (stage-2 refinement of the fused filter):
    #: entries are the rolling hash of each long pattern's first
    #: ``prefix_len`` bytes; a slot whose coarse word names exactly one
    #: alignment is kept only if its window's prefix hash probes positive
    #: — kills true-q-gram-collision strays (ops/filter_torch.py)
    prefix_words: Optional[np.ndarray] = None  # [2**prefix_log2 / 32] int32
    prefix_salts: Tuple[int, ...] = ()
    prefix_log2: int = 0
    prefix_len: int = 0


def _gram_code_u32(classes: Sequence[int], n_classes: int) -> int:
    """Host replica of the device's wrapping base-C code arithmetic."""
    code = 0
    for c in classes:
        code = (code * n_classes + int(c)) & 0xFFFFFFFF
    return code


def _own_pat(auto: CompiledAutomaton) -> np.ndarray:
    """Own-pattern id per final state — table-format agnostic (the
    compressed format has TWO final ranges, see
    CompressedAutomaton.is_final)."""
    own = np.full(auto.n_states, -1, dtype=np.int64)
    finals = np.nonzero(auto.is_final(np.arange(auto.n_states)))[0]
    if finals.size:
        first = auto.emit_pats[auto.emit_start[finals]]
        is_own = auto.pat_lens[first] == auto.state_depth[finals]
        own[finals[is_own]] = first[is_own]
    return own


#: measured per-lookup cost of the XLA gather unit on TPU v5e (seconds),
#: dispatch-amortized slab-scan rate (round-2 probe_filter_breakdown.py);
#: see docs/PERF_NOTES.md — table-size independent (16 KiB - 64 MiB).
_GATHER_S = 1 / 132e6
#: blocked grid compaction, amortized per grid cell.
_COMPACT_S = 5e-9
#: amortized host-verification cost per candidate start (vectorized numpy
#: root walk; most false candidates die within a few steps).
_VERIFY_S = 30e-9
#: hard cap on positional-bloom alignments (bits of an int32 word).
_MAX_STRIDE = 32
#: skip exact gram enumeration above this many (pattern, alignment) entries.
_ENUM_CAP = 64_000_000
#: build the second-code-family bloom once this many (pattern, alignment)
#: entries make 32-bit code collisions non-negligible (n/2^32 per cell)
WORDS2_MIN_ENTRIES = 1 << 20


def _alignment_gram_codes(
    longs: Sequence[bytes], q: int, s: int, base: int = GRAM_BASE
) -> Tuple[np.ndarray, np.ndarray]:
    """``(codes, aligns)`` of every long pattern's q-gram at offsets
    ``[0, s)`` — wrapping uint32 polynomial byte codes, bit-identical to
    the device's int32 arithmetic (the fused kernel's code assembly,
    base GRAM_BASE)."""
    by_len: dict = {}
    for p in longs:
        by_len.setdefault(len(p), []).append(p)
    codes: List[np.ndarray] = []
    aligns: List[np.ndarray] = []
    base = np.uint32(base)
    for n, ps in sorted(by_len.items()):
        arr = np.frombuffer(b"".join(ps), np.uint8).reshape(len(ps), n)
        u = arr.astype(np.uint32)
        for j in range(s):  # s <= min_long - q + 1 <= n - q + 1
            c = np.zeros(len(ps), np.uint32)
            for t in range(q):
                c = c * base + u[:, j + t]
            codes.append(c)
            aligns.append(np.full(len(ps), j, np.int32))
    return np.concatenate(codes), np.concatenate(aligns)


def _sampled_cost(
    q: int,
    s: int,
    n_entries: int,
    log2_w: int,
    n_probes: int,
    A: int,
    max_len: int,
) -> Tuple[float, float]:
    """Per-byte cost estimate + per-lookup hit rate of one sampled config
    (constants from the measured primitives in docs/PERF_NOTES.md)."""
    true_density = min(1.0, n_entries / float(A) ** q)
    # A grid cell strays at alignment j when, in EVERY one of the n_probes
    # salted probe words, bit j was set by some pattern with a gram at
    # offset j hashing to the same slot.  Patterns per offset = n_entries/s,
    # so per-bit fill = (n_entries/s) / W and the cell strays at any of its
    # s alignments: ~ s * fill^n.  (Measured 2026-08-18 at signature scale:
    # an optimistic 1-probe estimate here flooded device verify, 404 ->
    # 634 ms per 64 MiB — the second probe pays for itself.)
    fill = (n_entries / float(s)) / float(1 << log2_w)
    stray = s * fill ** n_probes
    hit_rate = min(1.0, 1.1 * true_density + stray)
    win_len = s - 1 + max_len
    if win_len <= 32:  # device window verify: per hit-capacity slot, one
        # byte gather, one class gather, and one table gather per window
        # position (measured 44 ms at H=65536, W=23 => ~3 gathers/step,
        # probe_phaseb.py).  The kernel walks the full static capacity
        # H = next_pow2(1.25 * hits), not n_hits — model that padding as
        # an average 1.6x on the hit rate.
        verify = _GATHER_S * (3 * win_len + 2) * 1.6 * hit_rate / s
    else:  # host expand + verify through the relay
        verify = 300e-9 * hit_rate / s
    # grid gram-code assembly: strides with s % 4 == 0 take the
    # cell-aligned word-plane path (measured 0.042 ns/byte vs 0.123 for
    # the general [B, M, s] reshape path whose sub-128 minor dim pays
    # 16x physical tile padding — probe_planes2.py, round 3)
    codes = 0.042e-9 if s % 4 == 0 else 0.123e-9
    cost = _GATHER_S * n_probes / s + _COMPACT_S / s + verify + codes
    return cost, hit_rate


#: coarse VMEM-bloom stray ceiling: survivors per grid cell the XLA fine
#: stage re-probes (per-survivor cost ~3 gathers; at 0.01 the fine machinery
#: stays an order of magnitude under the replaced dense gather pass)
_VMEM_MAX_STRAY = 0.01
#: hard cap on total bank-select steps per 1024-code tile (= k * N / 128):
#: each step is ~4 VPU ops, so the cap bounds kernel cost well under the
#: ~132 M lookups/s XLA gather wall it replaces
_VMEM_MAX_BANK_STEPS = 768


def _plan_vmem_bloom(
    codes: np.ndarray,  # [n_longs * s] uint32 alignment gram codes
    aligns: np.ndarray,  # [n_longs * s] int32 alignments
    n_longs: int,
    stride: int,
    config: ScanConfig,
) -> Optional[dict]:
    """Build the bank-select VMEM positional blooms when they stay
    selective (ops/filter_pallas.bloom_word_vmem).

    Layout: ``k`` independent probe tables of ``N = 2**log2_rows`` int32
    words each, stacked ``[k * N/128, 128]``; an entry ``(code, align j)``
    sets bit ``j`` of word ``hash_salt_p(code)`` in every probe table; a
    query ANDs the ``k`` probed words.  Per alignment bit-plane each table
    is a 1-hash bloom of ``n_longs`` entries over ``N`` bits —
    false-positive ``fp = fill^k`` with ``fill = 1 - exp(-n/N)``; a grid
    cell strays when ANY of its ``stride`` planes does (~``stride * fp``).

    The kernel's cost is ``k * N/128`` bank-select steps per 1024 codes,
    so the planner minimizes ``k * N`` subject to the stray bound (the XLA
    fine stage re-probes survivors against the big HBM bloom, so the bound
    only caps intermediate compaction + fine-gather work, not
    correctness).  Returns None when no (N, k) within the VMEM budget
    meets the bound (the take path stays in charge)."""
    budget_words = max(config.cascade_vmem_bloom_bytes // 4, 1 << 12)
    best = None
    for log2_rows in range(12, 21):
        N = 1 << log2_rows
        fill = 1.0 - np.exp(-n_longs / N)
        for k in range(2, 9):
            if k * N > budget_words or k * N // 128 > _VMEM_MAX_BANK_STEPS:
                continue
            stray = stride * fill**k
            if stray > _VMEM_MAX_STRAY:
                continue
            cost = k * N
            if best is None or cost < best[0] or (
                cost == best[0] and stray < best[3]
            ):
                best = (cost, log2_rows, k, stray)
            break  # larger k at this N only costs more
    if best is None:
        return None
    _, log2_rows, k, stray = best
    N = 1 << log2_rows
    salts = tuple((0x9E3779B9 * (2 * i + 1)) & 0xFFFFFFFF for i in range(k))
    n_banks = N // 128
    words = np.zeros((k * n_banks, 128), dtype=np.uint32)
    bits = np.uint32(1) << aligns.astype(np.uint32)
    for p, salt in enumerate(salts):
        h = (codes ^ np.uint32(salt)) * np.uint32(KNUTH)
        rows = (h >> np.uint32(32 - log2_rows)).astype(np.int64)
        flat = words.reshape(-1)
        native.scatter_or(flat, p * N + rows, bits)
    # subword bank packing: a positional word only uses ``stride``
    # alignment bits, so up to 32/stride banks share one physical int32
    # row — the kernel's bank-select loop (its cost = physical rows)
    # shrinks by the pack factor (4x at the headline's stride 8)
    pack = 4 if stride <= 8 else (2 if stride <= 16 else 1)
    if pack > 1:
        w = 32 // pack
        per = words.reshape(k, n_banks // pack, pack, 128)
        packed = np.zeros((k, n_banks // pack, 128), np.uint32)
        for i in range(pack):
            packed |= per[:, :, i, :] << np.uint32(i * w)
        words = packed.reshape(k * (n_banks // pack), 128)
    return dict(
        log2_rows=log2_rows,
        salts=salts,
        words=words.view(np.int32),
        pack=pack,
        stray=float(stray),
    )


def _plan_prefix_bloom(
    longs: Sequence[bytes], min_long: int, len_cap: int = 16
) -> dict:
    """Build the pattern-prefix bit bloom for stage-2 refinement: one
    entry per distinct ``prefix_len``-byte pattern prefix, hashed by the
    device's rolling polynomial (ops/filter_cuda._prefix_hash_select).
    Sized for <= ~1/512 fill per salt; a second salt squares the fill
    when the entry count forces a large table.  Vectorized per length
    group + native scatter."""
    l16 = min(min_long, max(4, min(len_cap, 16)))
    by_len: dict = {}
    for p in longs:
        by_len.setdefault(len(p), []).append(p)
    parts = []
    for n_, ps in sorted(by_len.items()):
        arr = np.frombuffer(b"".join(ps), np.uint8).reshape(len(ps), n_)
        u = arr[:, :l16].astype(np.uint32)
        h = np.zeros(len(ps), np.uint32)
        for j in range(l16):
            h = h * np.uint32(GRAM_BASE) + u[:, j]
        parts.append(h)
    hs = (
        np.unique(np.concatenate(parts))
        if parts
        else np.zeros(0, np.uint32)
    )
    n = max(hs.shape[0], 1)
    if n <= 8192:
        # small sets: size for ~1/16 fill per salt and probe TWO salts
        # (joint 1/256) — the table then fits <= 32 [*, 128] VMEM rows,
        # which lets the fused kernel refine its extracted slots
        # in-kernel instead of a 131k-slot XLA gather pass (round-5
        # stage budget: stage-2a was ~1-3 ms of the 16 ms headline pass)
        log2_p = max(int(np.ceil(np.log2(n))) + 4, 14)
        salts = (0x7F4A7C15, 0x94D049BB)
    else:
        log2_p = min(max(int(np.ceil(np.log2(n))) + 9, 14), 26)
        fill = n / (1 << log2_p)
        salts = (0x7F4A7C15, 0x94D049BB)[: (1 if fill <= 1 / 256 else 2)]
    words = np.zeros((1 << log2_p) // 32, dtype=np.uint32)
    for salt in salts:
        hh = (hs ^ np.uint32(salt)) * np.uint32(KNUTH)
        slots = (hh >> np.uint32(32 - log2_p)).astype(np.int64)
        native.scatter_or_bit(words, slots)
    return dict(
        words=words.view(np.int32), salts=salts, log2=log2_p, len=l16
    )


def _plan_sampled(
    longs: Sequence[bytes],
    auto: CompiledAutomaton,
    config: ScanConfig,
    min_long: int,
) -> Optional[dict]:
    """Pick ``(q, stride, log2_words, n_probes)`` for the strided
    positional bloom by a per-byte cost model.  Returns None when no
    sampled configuration is viable (e.g. min_long == q => stride 1, or
    candidate density saturates)."""
    A = max(int(auto.used_bytes.shape[0]), 1)
    n_longs = len(longs)
    max_w = config.cascade_log2_words_max
    max_len = auto.max_len
    best = None
    for q in range(min(16, min_long), config.cascade_min_q - 1, -1):
        s = min(_MAX_STRIDE, min_long - q + 1)
        if s < 2:
            continue
        n_entries = n_longs * s
        base_w = int(np.ceil(np.log2(max(n_entries, 1))))
        for n_probes in (1, 2):
            for log2_w in sorted({
                min(max(base_w + 5, 14), max_w),
                min(max(base_w + 8, 14), max_w),
                min(max(base_w + 10, 14), max_w),
            }):
                cost, hit_rate = _sampled_cost(
                    q, s, n_entries, log2_w, n_probes, A, max_len
                )
                cost += log2_w * 1e-12  # prefer smaller tables on ties
                cand = hit_rate / s
                if cand > config.cascade_max_cand_density:
                    continue
                if best is None or cost < best["cost"]:
                    best = dict(
                        q=q, stride=s, log2_words=log2_w,
                        n_probes=n_probes, cost=cost, cand_per_byte=cand,
                    )
    return best


def plan_cascade(
    patterns: Sequence[bytes],
    auto: CompiledAutomaton,
    config: ScanConfig,
) -> CascadePlan:
    if not patterns:
        return CascadePlan(False, "no patterns")
    longs = [p for p in patterns if len(p) >= config.cascade_min_q]
    shorts = tuple(p for p in patterns if len(p) < config.cascade_min_q)
    if len(shorts) > config.cascade_max_shorts:
        return CascadePlan(
            False, f"{len(shorts)} short patterns (> {config.cascade_max_shorts})"
        )
    log2_bits = config.cascade_log2_bloom_bits
    if not longs:
        return CascadePlan(
            True, "shorts-only", q=0, shorts=shorts, min_long_len=0,
            bloom_words=np.zeros((0, 1), np.int32), own_pat=_own_pat(auto),
        )
    min_long = min(len(p) for p in longs)

    if config.cascade_mode in ("auto", "sampled"):
        choice = _plan_sampled(longs, auto, config, min_long)
        if choice is not None and len(longs) * choice["stride"] <= _ENUM_CAP:
            q, s = choice["q"], choice["stride"]
            log2_w = choice["log2_words"]
            salts = (0x85EBCA6B, 0xC2B2AE35)[: choice["n_probes"]]

            codes, aligns = _alignment_gram_codes(longs, q, s)
            bits = np.uint32(1) << aligns.astype(np.uint32)
            words = np.zeros(1 << log2_w, dtype=np.uint32)
            for salt in salts:
                h = (codes ^ np.uint32(salt)) * np.uint32(KNUTH)
                widx = (h >> np.uint32(32 - log2_w)).astype(np.int64)
                native.scatter_or(words, widx, bits)
            # exact candidate-density estimate from the built filter
            n_distinct = np.unique(codes).shape[0]
            _, hit_rate = _sampled_cost(
                q, s, n_distinct, log2_w, len(salts),
                max(int(auto.used_bytes.shape[0]), 1), auto.max_len,
            )
            density = hit_rate / s
            if density <= config.cascade_max_cand_density:
                vmem = _plan_vmem_bloom(codes, aligns, len(longs), s, config)
                prefix = _plan_prefix_bloom(
                    longs, min_long, config.cascade_prefix_len
                )
                words2 = None
                if codes.shape[0] >= WORDS2_MIN_ENTRIES:
                    # 32-bit code space saturates: ~n/2^32 of random
                    # grams equal a true entry CODE and pass every salt;
                    # a second-family bloom makes that (n/2^32)^2
                    from ..ops.filter_torch import GRAM_BASE2, SALT2

                    codes2, _ = _alignment_gram_codes(
                        longs, q, s, base=GRAM_BASE2
                    )
                    w2 = np.zeros(1 << log2_w, dtype=np.uint32)
                    h2 = (codes2 ^ np.uint32(SALT2)) * np.uint32(KNUTH)
                    widx2 = (h2 >> np.uint32(32 - log2_w)).astype(np.int64)
                    native.scatter_or(w2, widx2, bits)
                    words2 = w2.view(np.int32)
                return CascadePlan(
                    True,
                    f"sampled q={q} stride={s} probes={len(salts)}"
                    + (
                        f" vmem k={len(vmem['salts'])}"
                        if vmem is not None
                        else ""
                    ),
                    q=q,
                    shorts=shorts,
                    min_long_len=min_long,
                    own_pat=_own_pat(auto),
                    mode="sampled",
                    stride=s,
                    log2_words=log2_w,
                    sampled_salts=salts,
                    sampled_words=words.view(np.int32),
                    sampled_words2=words2,
                    est_cand_density=density,
                    vmem_log2_rows=vmem["log2_rows"] if vmem else 0,
                    vmem_salts=vmem["salts"] if vmem else (),
                    vmem_words=vmem["words"] if vmem else None,
                    vmem_pack=vmem["pack"] if vmem else 1,
                    vmem_est_stray=vmem["stray"] if vmem else 0.0,
                    prefix_words=prefix["words"],
                    prefix_salts=prefix["salts"],
                    prefix_log2=prefix["log2"],
                    prefix_len=prefix["len"],
                )
        if config.cascade_mode == "sampled":
            return CascadePlan(
                False, "no viable sampled configuration for this pattern set"
            )
    q = min(8, min_long)
    # stage offsets: gram windows fully inside every long pattern
    offs = {0}
    if min_long - q >= 1:
        offs.add(min_long - q)
    if min_long - q >= 2:
        offs.add((min_long - q) // 2)
    offsets = tuple(sorted(offs))
    # bloom fill check: a saturated filter passes everything — not worth it
    if len(longs) > (1 << log2_bits) * config.cascade_max_fill:
        return CascadePlan(
            False,
            f"{len(longs)} long patterns saturate a 2^{log2_bits}-bit bloom",
        )
    bc = auto.byte_class
    C = auto.n_classes
    salts = tuple(0x9E3779B9 * (s + 1) & 0xFFFFFFFF for s in range(len(offsets)))
    words = np.zeros((len(offsets), (1 << log2_bits) // 32), dtype=np.uint32)
    for s, (off, salt) in enumerate(zip(offsets, salts)):
        for p in longs:
            cls = bc[np.frombuffer(p, np.uint8)[off : off + q]]
            code = _gram_code_u32(cls, C)
            h = ((code ^ salt) * KNUTH) & 0xFFFFFFFF
            slot = h >> (32 - log2_bits)
            words[s, slot >> 5] |= np.uint32(1) << np.uint32(slot & 31)
    return CascadePlan(
        True,
        "ok",
        q=q,
        offsets=offsets,
        salts=salts,
        log2_bits=log2_bits,
        bloom_words=words.view(np.int32),
        shorts=shorts,
        min_long_len=min_long,
        own_pat=_own_pat(auto),
    )


class CascadeModel:
    """Device candidate filter + exact verifier (device records or the
    host walk)."""

    def __init__(
        self,
        auto: CompiledAutomaton,
        plan: CascadePlan,
        config: ScanConfig,
        dense_model=None,  # DenseDfaModel or CompressedDfaModel: shares
        # its device table with the window verifier
        stats=None,  # utils.logging.ScanStats: capacity-retry counters
        device=None,
    ) -> None:
        assert plan.eligible
        import torch

        self.auto = auto
        self.plan = plan
        self.config = config
        self.dense_model = dense_model
        self.stats = stats
        self.device = torch.device(
            device if device is not None else dense_model.device
        )
        self._dev = None
        self._verify2_table = None
        self._verify_ktable = None
        #: adaptive capacities for the speculative filter -> verify chain
        #: (learned from each launch's observed counts; may shrink)
        self._cap_hits = 4096
        self._cap_flagged = 256
        #: stage-1 slot capacity: max coarse survivors per extraction
        #: group (a FUSED_BLOCK_R-row block column of the fused kernel or
        #: the grouped take filter, a 128-lane grid row of the per-row
        #: filter; structurally <= 128), seeded from the planner's stray
        #: estimate
        self._cap_coarse = 8
        self._force_take = False
        lam = None
        if plan.vmem_words is not None:
            from ..ops.filter_torch import FUSED_BLOCK_R

            lam = plan.vmem_est_stray * FUSED_BLOCK_R
        elif plan.mode == "sampled" and plan.log2_words:
            # grouped take filter: stage A probes one salt, so survivors
            # per cell ~ the single-salt stray
            lam = self._take_stray1() * self.take_group_block_r()
        if lam is not None:
            init = int(lam + 6.0 * lam**0.5 + 2)
            self._cap_coarse = max(8, min(128, -(-init // 8) * 8))
        self._cap_coarse_floor = self._cap_coarse

    def _take_stray1(self) -> float:
        """Per-cell single-salt stray estimate of the grouped take filter:
        stride alignment bits x the positional bloom's per-bit fill."""
        p = self.plan
        return min(
            1.0,
            p.stride * self.auto.n_patterns / float(1 << p.log2_words),
        )

    def take_group_block_r(self) -> int:
        """Group size of the grouped take filter's rank extraction, halved
        from ``FUSED_BLOCK_R`` (down to 128) until the expected survivors
        of a group at the single-salt stray are at most ~8."""
        from ..ops.filter_torch import FUSED_BLOCK_R

        p = self.plan
        if p.mode != "sampled" or not p.log2_words:
            return FUSED_BLOCK_R
        br = FUSED_BLOCK_R
        stray1 = self._take_stray1()
        while br > 128 and stray1 * br > 8.0:
            br //= 2
        return br

    @property
    def learned_caps(self) -> Tuple[int, int]:
        """Adaptive ``(cap_hits, cap_flagged)`` capacities learned from
        past launches — the starting point for a pipelined batch."""
        return max(self._cap_hits, 256), max(self._cap_flagged, 256)

    def seed_caps(
        self, n_hits_est: int, n_flagged_est: int, n_shards: int = 1
    ) -> None:
        """Pre-seed the adaptive capacities from workload knowledge (a
        known match density), so the first launch on a new corpus does not
        walk the doubling ladder.  Estimates are global; with ``n_shards >
        1`` each shard gets the mean plus a Poisson margin
        (:func:`~..parallel.shard_scan.per_shard_capacity`)."""
        from ..parallel.shard_scan import per_shard_capacity

        a = per_shard_capacity(max(n_hits_est, 1), n_shards)
        b = per_shard_capacity(max(n_flagged_est, 1), n_shards)
        self._cap_hits = max(self._cap_hits, _next_cap(a))
        self._cap_flagged = max(self._cap_flagged, _next_cap(b))

    def rescale_caps_per_shard(self, n_shards: int) -> None:
        """One-time rebase of the learned capacities on entering a sharded
        run: learning on one device saw global counts, each shard sees
        about ``1/n_shards`` of them.  Later sharded launches re-learn from
        the per-shard maximum, so this only sets the first."""
        from ..parallel.shard_scan import per_shard_capacity

        if getattr(self, "_caps_sharded_for", None) == n_shards:
            return
        self._caps_sharded_for = n_shards
        self._cap_hits = _next_cap(
            per_shard_capacity(self._cap_hits, n_shards)
        )
        self._cap_flagged = _next_cap(
            per_shard_capacity(self._cap_flagged, n_shards)
        )

    def on_device(self, device) -> "CascadeModel":
        """This model on ``device``: itself where that is its own device,
        else a copy whose device arrays are uploaded to ``device`` once and
        kept, and whose adaptive capacities are this model's, read at each
        call (a shard of a mesh runs its chain on its own card)."""
        import copy

        import torch

        device = torch.device(device)
        if device == self.device:
            return self
        reps = self.__dict__.setdefault("_replicas", {})
        r = reps.get(device)
        if r is None:
            r = copy.copy(self)
            r.device = device
            r._dev = r._verify2_table = r._verify_ktable = None
            r.dense_model = type(self.dense_model)(
                self.auto, self.config, device
            )
            r.stats = None
            reps[device] = r
        for k in ("_cap_hits", "_cap_flagged", "_cap_coarse",
                  "_cap_coarse_floor", "_force_take"):
            setattr(r, k, getattr(self, k))
        return r

    @property
    def win_len(self) -> int:
        """Window length of the device verifier: covers every occurrence
        owned by one grid cell (long starts in ``[p-stride+1, p]``, short
        starts in ``[p, p+stride)``)."""
        return self.plan.stride - 1 + self.auto.max_len

    @property
    def device_verify_ok(self) -> bool:
        """Device window verification needs the final-step bitmask to fit
        32 bits and a DFA model (dense or compressed) to share its
        table."""
        return (
            self.plan.mode == "sampled"
            and self.win_len <= 32
            and self.dense_model is not None
        )

    @property
    def _compressed(self) -> bool:
        from ..core.tables import CompressedAutomaton

        return isinstance(self.auto, CompressedAutomaton)

    @property
    def records_ok(self) -> bool:
        """Gate for device match-record emission: a reserved sentinel
        ``j`` (win_len <= 31) and states packable next to a 5-bit
        position (states < 2**26)."""
        return (
            self.device_verify_ok
            and self.win_len <= 31
            and self.auto.n_states < (1 << 26)
        )

    @property
    def records2_ok(self) -> bool:
        """Gate for the 2-class super-step record verifier: states fit the
        15-bit packed field and the composed [S, C, C] table stays within
        ``verify_kgram_bytes``."""
        from ..ops.filter_torch import REC2_BITS

        return (
            self.records_ok
            and not self._compressed
            and self.auto.n_states < (1 << REC2_BITS)
            and self.auto.n_states * self.auto.n_classes ** 2 * 4
            <= self.config.verify_kgram_bytes
        )

    @property
    def verify2_table_dev(self):
        """Lazy device upload of the packed 2-step verify table
        ``table2[s, c1*C + c2] = s2 | (s1 << 15)``."""
        if self._verify2_table is None:
            import torch

            from ..ops.filter_torch import REC2_BITS

            t = np.ascontiguousarray(self.auto.table, dtype=np.int64)
            S, C = t.shape
            s1 = t  # [S, C]
            s2 = t[s1.reshape(-1), :].reshape(S, C, C)  # [S, c1, c2]
            packed = (s2 | (s1[:, :, None] << REC2_BITS)).astype(np.int32)
            self._verify2_table = torch.from_numpy(packed.reshape(-1)).to(
                self.device
            )
        return self._verify2_table

    @property
    def verify_kv(self) -> int:
        """Super-step width of the flagged-window verifier's k-gram walk
        (1 = the plain per-class walk): the largest k in 2-4 whose composed
        table fits :attr:`ScanConfig.verify_kgram_bytes`.  Windows are not
        row-aligned, so k need not divide anything."""
        if self._compressed or self.auto.n_classes > 255:
            return 1  # byte-sized classes only
        from ..ops.scan_torch import KGRAM_MID_FLAG

        S, C = self.auto.n_states, self.auto.n_classes
        esize = 2 if (S < (1 << 15) and self.config.allow_int16_states) else 4
        if esize == 4 and S >= KGRAM_MID_FLAG:
            return 1
        kv = 1
        for k in (2, 3, 4):
            if (
                S * C**k * esize <= self.config.verify_kgram_bytes
                and S * C**k < 2**31
            ):
                kv = k
        return kv

    @property
    def verify_ktable_dev(self):
        """Lazy device upload of the verify k-gram table (composed once
        on the host)."""
        if self._verify_ktable is None:
            import torch

            from .kgram_dfa import KgramDfaModel

            km = KgramDfaModel(self.auto, self.config, self.device,
                               k=self.verify_kv)
            self._verify_ktable = torch.from_numpy(km.ktable_host).to(
                self.device
            )
        return self._verify_ktable

    @property
    def device_arrays(self):
        if self._dev is None:
            import torch

            auto = self.auto
            p = self.plan

            def put(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

            self._dev = {
                "byte_class": put(auto.byte_class.astype(np.int32)),
                "used_bytes": put(auto.used_bytes),
                "min_long_len": torch.tensor(
                    p.min_long_len, dtype=torch.int32, device=self.device
                ),
            }
            if p.mode == "sampled":
                self._dev["sampled_words"] = put(p.sampled_words)
                if p.vmem_words is not None:
                    # [k * n_banks / pack, 128] bank tables, staged in
                    # shared memory by the fused kernel
                    self._dev["vmem_table"] = put(p.vmem_words)
                if p.prefix_words is not None:
                    self._dev["prefix_words"] = put(p.prefix_words)
                if p.sampled_words2 is not None:
                    self._dev["sampled_words2"] = put(p.sampled_words2)
            else:
                self._dev["bloom_words"] = put(p.bloom_words)
        return self._dev

    def bloom_impl(self) -> str:
        """The filter implementation, by one rule on every device (the
        CPU runs the card's route):

        - anchored plans: ``"pallas"``, whatever the setting: they probe
          through the ``bloom_hit`` kernel, which on the card beats
          ``bloom_hit_take`` at every shape measured (on a CPU bloom its
          wrapper runs ``bloom_hit_take``);
        - sampled plans: ``"take"`` (the take filters, which probe the
          positional bloom by gathers) once a launch saw more than 128
          survivors in one extraction group (``_force_take``, for good),
          for the settings ``"take"`` and ``"pallas"``, and wherever the
          planner built no bank bloom; else ``"pallas_vmem"`` (the
          bank-bloom filters), for ``"auto"`` and ``"pallas_vmem"``."""
        impl = self.config.bloom_impl
        if self.plan.mode != "sampled":
            return "pallas"
        if (
            self._force_take
            or impl in ("take", "pallas")
            or self.plan.vmem_words is None
        ):
            return "take"
        return "pallas_vmem"

    def take_branch(self, row_len: int, cap_coarse: Optional[int] = None):
        """The take filter a launch over rows of ``row_len`` bytes runs:
        ``"grouped"`` where the stride is a multiple of 4 dividing the
        row, the slot capacity is at most 128 and ``_force_take`` is
        unset, else ``"flat"``."""
        s = self.plan.stride
        cc = cap_coarse or self._cap_coarse
        if (
            not self._force_take
            and s % 4 == 0
            and row_len % s == 0
            and cc <= 128
        ):
            return "grouped"
        return "flat"

    def adaptive_chain(self, launch):
        """Drive one speculative filter -> verify chain with capacity
        learning.  ``launch(cap_a, cap_b)`` returns ``(cells, n_hits,
        n_flagged, n_coarse)`` with host ints for the counts; overflowing
        any stage retries with that capacity grown."""
        cap_a = max(self._cap_hits, 256)
        cap_b = self._cap_flagged
        while True:
            cells, n, nf, nc = launch(cap_a, cap_b)
            if n <= cap_a and nf <= cap_b and nc <= self._cap_coarse:
                break
            if n > cap_a:
                self._count_retry("filter", n, cap_a)
                cap_a = _next_cap(n)
            if nf > cap_b:
                self._count_retry("verify", nf, cap_b)
                cap_b = _next_cap(nf)
            if nc > self._cap_coarse:
                self._count_retry("coarse", nc, self._cap_coarse)
                self._grow_cap_coarse(nc)
        self._cap_hits = max(256, _next_cap(n + n // 4))
        self._cap_flagged = cap_b
        self._decay_cap_coarse(nc)
        return cells, nf

    def _count_retry(self, stage: str, observed: int, cap: int) -> None:
        if self.stats is not None:
            self.stats.record_capacity_retry(stage, observed, cap)

    def _grow_cap_coarse(self, nc: int) -> None:
        """Grow the stage-1 slot cap after an overflow; past the 128-slot
        ceiling of the extraction, switch for good to the flat take
        filter (exact, no slot capacity) instead of spinning."""
        if _next_pow2(nc) > 128:
            self._force_take = True
        else:
            self._cap_coarse = min(128, _next_pow2(nc))

    def _decay_cap_coarse(self, nc: int) -> None:
        """Decay the learned stage-1 slot cap back toward the planner seed
        once dense launches stop recurring."""
        floor = self._cap_coarse_floor
        if self._cap_coarse > floor and nc <= self._cap_coarse // 2:
            self._cap_coarse = max(floor, self._cap_coarse // 2)

    def launch_device(self, chunks_d, lengths_d, cap_a, cap_b,
                      phase_g=None):
        """One speculative filter -> flagged-window verify chain, entirely
        on the device.  Returns ``(cells, n_d, nf_d, nc_d)`` as device
        values (no host fetch); the counts are checked against ``cap_a``,
        ``cap_b`` and ``self._cap_coarse`` after the fetch (overflow:
        retry bigger).  The verifier is the k-gram walk where
        :attr:`verify_kv` > 1, the compressed walk on a compressed table,
        else the per-class dense walk."""
        idx, _lw, _sw, n_d, nc_d = self.scan_hits_sampled(
            chunks_d, lengths_d, cap_a, phase_g=phase_g
        )
        cells, nf_d = self.verify_hits(chunks_d, lengths_d, idx, cap_a, cap_b)
        return cells, n_d, nf_d, nc_d

    def verify_hits(self, chunks_d, lengths_d, idx, cap_a, cap_b,
                    kgram: bool = True):
        """The flagged-window verify of ``idx`` (grid hits, ``cap_a``
        slots): ``(cells [cap_b], nf_d)``.  The walk is the compressed one
        on a compressed table, the k-gram one where ``kgram`` and
        :attr:`verify_kv` > 1, else the per-class dense walk."""
        from ..ops.filter_torch import (
            verify_windows, verify_windows_compressed, verify_windows_kgram,
        )

        dd = self.dense_model.device_arrays
        dev = self.device_arrays
        win = dict(stride=self.plan.stride, win_len=self.win_len,
                   capacity=cap_b, n_hits=cap_a)
        if self._compressed:
            cells, nf_d = verify_windows_compressed(
                dd["dense_flat"], dd["meta"], dd["exc_target"],
                dev["byte_class"], dev["used_bytes"], chunks_d, lengths_d,
                idx, dd["dense_final_start"], dd["final_start"],
                n_classes=self.auto.n_classes, n_dense=self.auto.n_dense,
                **win,
            )
        elif kgram and self.verify_kv > 1:
            cells, nf_d = verify_windows_kgram(
                self.verify_ktable_dev, dev["byte_class"], dev["used_bytes"],
                chunks_d, lengths_d, idx, dd["final_start"],
                n_classes=self.auto.n_classes, kv=self.verify_kv, **win,
            )
        else:
            cells, nf_d = verify_windows(
                dd["table_flat"], dev["byte_class"], dev["used_bytes"],
                chunks_d, lengths_d, idx, dd["final_start"],
                n_classes=self.auto.n_classes, **win,
            )
        return cells, nf_d

    def launch_device_records(
        self, chunks_d, lengths_d, emit_from_d, cap_a, cap_r, phase_g=None,
    ):
        """Speculative filter -> record-verify chain, entirely on device.
        Returns ``(rec_cell, rec_pack, n_d, nr_d, nc_d)`` as device values
        (no host fetch), so callers can keep several chains in flight.
        The bank-bloom route runs :func:`records_chain_vmem`; the take
        route runs :meth:`scan_hits_sampled` and the one-class-a-step
        verifier (:func:`verify_windows_records`, or
        :func:`verify_windows_records_compressed` on a compressed table),
        as the reference does."""
        from ..ops.filter_torch import (
            records_chain_vmem, verify_windows_records,
            verify_windows_records_compressed,
        )

        dd = self.dense_model.device_arrays
        dev = self.device_arrays
        p = self.plan
        comp = self._compressed
        win = dict(n_classes=self.auto.n_classes, stride=p.stride,
                   win_len=self.win_len, capacity=cap_r, n_hits=cap_a)
        if self.bloom_impl() != "pallas_vmem":
            idx, _lw, _sw, n_d, nc_d = self.scan_hits_sampled(
                chunks_d, lengths_d, cap_a, phase_g=phase_g
            )
            if comp:
                rec_cell, rec_pack, nr_d = verify_windows_records_compressed(
                    dd["dense_flat"], dd["meta"], dd["exc_target"],
                    dev["byte_class"], dev["used_bytes"], chunks_d,
                    lengths_d, emit_from_d, idx, dd["dense_final_start"],
                    dd["final_start"], n_dense=self.auto.n_dense, **win,
                )
            else:
                rec_cell, rec_pack, nr_d = verify_windows_records(
                    dd["table_flat"], dev["byte_class"], dev["used_bytes"],
                    chunks_d, lengths_d, emit_from_d, idx,
                    dd["final_start"], **win,
                )
            return rec_cell, rec_pack, n_d, nr_d, nc_d
        use_k2 = self.records2_ok
        if comp:
            tflat = dd["dense_flat"]
        elif use_k2:
            tflat = self.verify2_table_dev
        else:
            tflat = dd["table_flat"]
        extra = dict(
            compressed=True, meta=dd["meta"], exc_target=dd["exc_target"],
            dense_final_start=dd["dense_final_start"],
            n_dense=self.auto.n_dense,
        ) if comp else dict(use_k2=use_k2)
        return records_chain_vmem(
            dev["vmem_table"],
            dev["sampled_words"],
            dev.get("prefix_words"),
            tflat,
            dev["byte_class"],
            dev["used_bytes"],
            chunks_d,
            lengths_d,
            emit_from_d,
            dev["min_long_len"],
            dd["final_start"],
            phase_g,
            q=p.q,
            stride=p.stride,
            log2_rows=p.vmem_log2_rows,
            salts=p.vmem_salts,
            pack=p.vmem_pack,
            log2_words=p.log2_words,
            fine_salts=p.sampled_salts,
            shorts=p.shorts,
            cap_a=cap_a,
            cap_coarse=self._cap_coarse,
            prefix_salts=p.prefix_salts if "prefix_words" in dev else (),
            prefix_log2=p.prefix_log2,
            prefix_len=p.prefix_len,
            n_classes=self.auto.n_classes,
            win_len=self.win_len,
            cap_r=cap_r,
            **extra,
        )

    def _device_inputs(self, packed: PackedRows, dev_inputs):
        """``(chunks, lengths, emit_from, phase_g)`` on the device: the
        resident tensors of ``dev_inputs`` where given (``phase_g`` None
        when absent), else one upload of ``packed``."""
        import torch

        if dev_inputs is not None:
            phase_g = dev_inputs[3] if len(dev_inputs) > 3 else None
            return tuple(dev_inputs[:3]) + (phase_g,)
        return tuple(
            torch.from_numpy(x).to(self.device)
            for x in (packed.chunks, packed.lengths, packed.emit_from)
        ) + (None,)

    def run_arrays(self, packed: PackedRows, capacity: int, dev_inputs=None):
        """Full cascade on one device; returns ``(docs, end_pos, pids)``
        arrays in reference emission order.  Sampled plans whose windows
        fit the records gate emit match records from the device; other
        sampled plans with windows of at most 32 bytes flag matching
        windows on the device and re-walk them on the host; the anchored
        plan and sampled plans with longer windows verify fetched
        candidate starts on the host.  Counts stay device values until
        one fetch a launch.

        ``dev_inputs``: optional ``(chunks, lengths, emit_from[,
        phase_g])`` already on the device (resident-corpus callers)."""
        import torch

        if not (self.plan.mode == "sampled" and self.device_verify_ok):
            idx_np, n = self.candidates_np(packed, capacity, dev_inputs)
            return self.verify_arrays(packed, idx_np, n)
        chunks_d, lengths_d, emit_from_d, phase_g = self._device_inputs(
            packed, dev_inputs
        )
        z = np.zeros(0, np.int64)
        if self.records_ok:

            def launch_r(cap_a, cap_r):
                rc, rp, n_d, nr_d, nc_d = self.launch_device_records(
                    chunks_d, lengths_d, emit_from_d, cap_a, cap_r,
                    phase_g=phase_g,
                )
                n, nr, nc = torch.stack([n_d, nr_d, nc_d]).tolist()
                return (rc, rp), n, nr, nc

            (rc, rp), nr = self.adaptive_chain(launch_r)
            if nr == 0:
                return z, z, z
            return self.emit_records_arrays(
                packed, rc[:nr].cpu().numpy(), rp[:nr].cpu().numpy(), nr
            )

        def launch(cap_a, cap_b):
            cells, n_d, nf_d, nc_d = self.launch_device(
                chunks_d, lengths_d, cap_a, cap_b, phase_g=phase_g,
            )
            n, nf, nc = torch.stack([n_d, nf_d, nc_d]).tolist()
            return cells, n, nf, nc

        cells, nf = self.adaptive_chain(launch)
        if nf == 0:
            return z, z, z
        return self.emit_windows_arrays(packed, cells[:nf].cpu().numpy(), nf)

    def run(self, packed: PackedRows, capacity: int, dev_inputs=None):
        """Iterator facade over :meth:`run_arrays`."""
        return _records_iter(*self.run_arrays(packed, capacity, dev_inputs))

    def emit_records_arrays(
        self,
        packed: PackedRows,
        rec_cell: np.ndarray,
        rec_pack: np.ndarray,
        n_rec: int,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Expand device match records into ``(docs, end_pos, pids)``
        arrays in reference emission order — vectorized csr expansion +
        the per-pattern ownership rule; no window re-walk.  Windows that
        overflowed their record slots arrive as sentinel records and are
        re-walked exactly via :meth:`emit_windows_arrays` (their normal
        records are discarded to avoid double emission)."""
        from ..ops.filter_torch import REC_OVERFLOW_J
        from ..ops.matches import csr_expand

        z = np.zeros(0, np.int64)
        if n_rec == 0:
            return z, z, z
        auto = self.auto
        s = self.plan.stride
        L = packed.row_len
        M = -(-L // s)
        cell = rec_cell[:n_rec].astype(np.int64)
        pack = rec_pack[:n_rec].astype(np.int64)
        j = pack & 31
        sentinel = j == REC_OVERFLOW_J
        parts: List[np.ndarray] = []
        if sentinel.any():
            over_cells = np.unique(cell[sentinel])
            keep_n = ~np.isin(cell, over_cells)
            docs_o, ends_o, pids_o = self.emit_windows_arrays(
                packed, over_cells, over_cells.shape[0]
            )
            cell, pack, j = cell[keep_n], pack[keep_n], j[keep_n]
        else:
            docs_o = None
        if cell.shape[0]:
            state = pack >> 5
            b = cell // M
            m = cell % M
            e = m * s - (s - 1) + j  # end-1 byte index within the row
            rec_of, pids = csr_expand(auto, state)
            src_b = b[rec_of]
            src_e = e[rec_of]
            src_m = m[rec_of]
            ln = auto.pat_lens[pids].astype(np.int64)
            t = src_e + 1 - ln
            short_limit = self.config.cascade_min_q
            owner = np.where(ln >= short_limit, -(-t // s), t // s)
            keep = owner == src_m
            if keep.any():
                parts.append(
                    np.stack(
                        [src_b[keep], src_e[keep] + 1, t[keep], pids[keep]]
                    )
                )
        if not parts:
            if docs_o is not None:
                return docs_o, ends_o, pids_o
            return z, z, z
        arr = np.concatenate(parts, axis=1)
        order = np.lexsort((arr[2], arr[1], arr[0]))
        docs = packed.doc_id[arr[0, order]].astype(np.int64)
        ends = packed.global_off[arr[0, order]] + arr[1, order]
        pids_n = arr[3, order]
        if docs_o is not None and docs_o.shape[0]:
            # merge the (rare) overflow emissions by (doc, end, start)
            starts_n = ends - auto.pat_lens[pids_n]
            starts_o = ends_o - auto.pat_lens[pids_o]
            allc = np.concatenate
            docs, ends, pids_all, starts = (
                allc([docs, docs_o]),
                allc([ends, ends_o]),
                allc([pids_n, pids_o]),
                allc([starts_n, starts_o]),
            )
            o2 = np.lexsort((starts, ends, docs))
            return docs[o2], ends[o2], pids_all[o2]
        return docs, ends, pids_n

    def emit_windows_arrays(
        self, packed: PackedRows, win_cells: np.ndarray, n_flagged: int
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host re-walk of the (rare) flagged windows; applies the
        exactly-once ownership rules and returns ``(docs, end_pos, pids)``
        arrays in reference emission order — vectorized per window step
        and per emission (no per-record Python loop).

        Ownership: a long occurrence at start ``t`` belongs to the window
        of its guaranteed grid hit ``ceil(t / stride)``; a short one to
        ``floor(t / stride)`` — each match is accepted by exactly one
        flagged window even when neighboring windows overlap it."""
        z = np.zeros(0, np.int64)
        if n_flagged == 0:
            return z, z, z
        from ..ops.matches import csr_expand

        auto = self.auto
        s = self.plan.stride
        L = packed.row_len
        M = -(-L // s)
        g = win_cells[:n_flagged].astype(np.int64)
        rows = g // M
        m = g % M
        w0 = m * s - (s - 1)
        bc = auto.byte_class
        row_len = packed.lengths[rows].astype(np.int64)
        row_emit = packed.emit_from[rows].astype(np.int64)
        short_limit = self.config.cascade_min_q
        states = np.zeros(g.shape[0], dtype=np.int64)
        parts: List[np.ndarray] = []  # [4, n] stacks of (row, end, start, pid)
        for j in range(self.win_len):
            pos = w0 + j
            valid = (pos >= 0) & (pos < row_len)
            byte = packed.chunks[rows, np.clip(pos, 0, L - 1)]
            cls = np.where(valid, bc[byte], 0)
            states = auto.lookup(states, cls).astype(np.int64)
            emit = (
                auto.is_final(states)
                & valid
                & (pos >= row_emit)
                & (pos < row_len)
            )
            fin = np.nonzero(emit)[0]
            if fin.size == 0:
                continue
            rec_of, pids = csr_expand(auto, states[fin])
            src = fin[rec_of]
            e = pos[src]  # end-1 byte index
            ln = auto.pat_lens[pids].astype(np.int64)
            t = e + 1 - ln
            owner = np.where(ln >= short_limit, -(-t // s), t // s)
            keep = owner == m[src]
            if keep.any():
                parts.append(
                    np.stack(
                        [rows[src][keep], e[keep] + 1, t[keep], pids[keep]]
                    )
                )
        if not parts:
            return z, z, z
        arr = np.concatenate(parts, axis=1)  # [4, n]
        order = np.lexsort((arr[2], arr[1], arr[0]))
        docs = packed.doc_id[arr[0, order]].astype(np.int64)
        ends = packed.global_off[arr[0, order]] + arr[1, order]
        return docs, ends, arr[3, order]

    def emit_windows(
        self, packed: PackedRows, win_cells: np.ndarray, n_flagged: int
    ) -> Iterator[Tuple[int, int, np.ndarray]]:
        """Iterator facade over :meth:`emit_windows_arrays`."""
        return _records_iter(
            *self.emit_windows_arrays(packed, win_cells, n_flagged)
        )

    def scan_hits_sampled(
        self, chunks, lengths, capacity: int,
        cap_coarse: Optional[int] = None, phase_g=None,
    ):
        """One launch of the sampled filter :meth:`bloom_impl` names: the
        bank-bloom filter (fused where the alignment gate holds, else per
        row), or the take filter of :meth:`take_branch` (grouped or
        flat).  Returns ``(grid_idx, long_word, short_word, n_hits,
        n_coarse)`` as device values; ``n_coarse`` is the most survivors
        of one extraction group, which must not exceed the slot capacity
        ``self._cap_coarse`` (the flat take filter has no slots and
        reports 0)."""
        import torch

        from ..ops.filter_torch import (
            filter_hits_sampled, filter_hits_sampled_grouped,
            filter_hits_sampled_vmem,
        )

        dev = self.device_arrays
        p = self.plan
        cc = cap_coarse or self._cap_coarse
        if self.bloom_impl() == "take":
            if self.take_branch(chunks.shape[1], cc) == "grouped":
                return filter_hits_sampled_grouped(
                    dev["sampled_words"],
                    chunks,
                    lengths,
                    dev["min_long_len"],
                    q=p.q,
                    stride=p.stride,
                    log2_words=p.log2_words,
                    salts=p.sampled_salts,
                    shorts=p.shorts,
                    capacity=capacity,
                    cap_coarse=cc,
                    prefix_words=dev.get("prefix_words"),
                    prefix_salts=p.prefix_salts,
                    prefix_log2=p.prefix_log2,
                    prefix_len=p.prefix_len,
                    block_r=self.take_group_block_r(),
                    words2=dev.get("sampled_words2"),
                )
            idx, lw, sw, n = filter_hits_sampled(
                dev["sampled_words"],
                chunks,
                lengths,
                dev["min_long_len"],
                q=p.q,
                stride=p.stride,
                log2_words=p.log2_words,
                salts=p.sampled_salts,
                shorts=p.shorts,
                capacity=capacity,
            )
            return idx, lw, sw, n, torch.zeros_like(n)
        return filter_hits_sampled_vmem(
            dev["vmem_table"],
            dev["sampled_words"],
            chunks,
            lengths,
            dev["min_long_len"],
            q=p.q,
            stride=p.stride,
            log2_rows=p.vmem_log2_rows,
            salts=p.vmem_salts,
            pack=p.vmem_pack,
            log2_words=p.log2_words,
            fine_salts=p.sampled_salts,
            shorts=p.shorts,
            capacity=capacity,
            cap_coarse=cc,
            prefix_words=dev.get("prefix_words"),
            prefix_salts=p.prefix_salts,
            prefix_log2=p.prefix_log2,
            prefix_len=p.prefix_len,
            phase_g=phase_g,
        )

    def expand_hits(
        self,
        grid_idx: np.ndarray,
        long_word: np.ndarray,
        short_word: np.ndarray,
        n_hits: int,
        row_len: int,
        lengths: np.ndarray,  # [B] int32 (host copy)
    ) -> Tuple[np.ndarray, int]:
        """Host expansion of compacted grid hits into sorted unique
        candidate-start indices (flattened ``b * L + t``)."""
        p = self.plan
        s = p.stride
        M = -(-row_len // s)
        g = grid_idx[:n_hits].astype(np.int64)
        lw = long_word[:n_hits].astype(np.int64) & 0xFFFFFFFF
        sw = short_word[:n_hits].astype(np.int64) & 0xFFFFFFFF
        b = g // M
        pos = (g % M) * s
        base = b * row_len
        min_long = p.min_long_len
        parts: List[np.ndarray] = []
        for j in range(s):
            sel = (lw >> j) & 1 != 0
            if sel.any():
                t = pos[sel] - j
                ok = (t >= 0) & (t + min_long <= lengths[b[sel]])
                parts.append(base[sel][ok] + t[ok])
            sel = (sw >> j) & 1 != 0
            if sel.any():  # short starts: already length-gated on device
                parts.append(base[sel] + pos[sel] + j)
        if not parts:
            return np.zeros(0, np.int64), 0
        starts = np.unique(np.concatenate(parts))
        return starts, starts.shape[0]

    def candidates_np(self, packed: PackedRows, capacity: int,
                      dev_inputs=None):
        """Device filter + capacity retry + (sampled) host bit expansion.
        Returns ``(start_idx np, n_starts)`` ready for
        :meth:`verify_arrays`.  The anchored filter starts every call at
        ``capacity`` and retries once at the observed count, as the
        reference does.  ``dev_inputs`` as in :meth:`run_arrays`; the
        reference uploads ``packed`` again instead, with the same
        result."""
        import torch

        chunks_d, lengths_d, _, phase_g = self._device_inputs(
            packed, dev_inputs
        )
        if self.plan.mode == "sampled":
            while True:
                idx, lw, sw, n_d, nc_d = self.scan_hits_sampled(
                    chunks_d, lengths_d, capacity, phase_g=phase_g
                )
                n, nc = torch.stack([n_d, nc_d]).tolist()
                if n <= capacity and nc <= self._cap_coarse:
                    break
                if n > capacity:
                    self._count_retry("filter", n, capacity)
                    capacity = _next_cap(n)
                if nc > self._cap_coarse:
                    self._count_retry("coarse", nc, self._cap_coarse)
                    self._grow_cap_coarse(nc)
            self._decay_cap_coarse(nc)
            flat = torch.cat([idx[:n], lw[:n], sw[:n]]).cpu().numpy()
            return self.expand_hits(
                flat[:n], flat[n : 2 * n], flat[2 * n :], n,
                packed.row_len, packed.lengths,
            )
        while True:
            idx, n_d = self.scan_candidates(chunks_d, lengths_d, capacity)
            n = int(n_d)
            if n <= capacity:
                break
            capacity = _next_cap(n)
        return idx[:n].cpu().numpy(), n

    def scan_candidates(self, chunks, lengths, capacity: int):
        """One launch of the anchored candidate filter: ``(start_idx
        [capacity], n_candidates)`` as device values.  Ownership
        (``emit_from``) is left to :meth:`verify_arrays`."""
        from ..ops.filter_torch import filter_candidates

        dev = self.device_arrays
        p = self.plan
        assert p.mode != "sampled", "use scan_hits_sampled / candidates_np"
        return filter_candidates(
            dev["bloom_words"],
            dev["byte_class"],
            dev["used_bytes"],
            chunks,
            lengths,
            dev["min_long_len"],
            n_classes=self.auto.n_classes,
            q=p.q,
            offsets=p.offsets,
            log2_bits=p.log2_bits,
            salts=p.salts,
            shorts=p.shorts,
            capacity=capacity,
        )

    def verify_arrays(
        self,
        packed: PackedRows,
        start_idx: np.ndarray,  # [>= n_cand] flattened b * L + p, ascending
        n_cand: int,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Exact verification: vectorized goto-walk from root over each
        candidate window; returns ``(docs, end_pos, pids)`` arrays in
        reference emission order ``(row, end, start)``."""
        if n_cand == 0:
            z = np.zeros(0, np.int64)
            return z, z, z
        auto = self.auto
        L = packed.row_len
        idx = start_idx[:n_cand].astype(np.int64)
        rows = idx // L
        ps = idx % L
        bc = auto.byte_class
        depth = auto.state_depth
        own = self.plan.own_pat
        row_len = packed.lengths[rows].astype(np.int64)
        row_emit = packed.emit_from[rows].astype(np.int64)

        # active-set walk: candidates that fall off the pure-prefix path are
        # compacted away each level, so total work tracks the (rapidly
        # decaying) survivor count rather than candidates x max_len
        act = np.arange(idx.shape[0])
        states = np.zeros(idx.shape[0], dtype=np.int64)
        out_rows: List[np.ndarray] = []
        out_end: List[np.ndarray] = []
        out_start: List[np.ndarray] = []
        out_pid: List[np.ndarray] = []
        for j in range(auto.max_len):
            pos = ps[act] + j
            in_row = pos < row_len[act]
            if not in_row.all():
                act = act[in_row]
                pos = pos[in_row]
            if act.size == 0:
                break
            b = packed.chunks[rows[act], pos]
            st = auto.lookup(states[act], bc[b]).astype(np.int64)
            states[act] = st
            on_path = depth[st] == j + 1  # left the pure-prefix path?
            o = own[st]
            # end-1 byte index = pos; ownership window [emit_from, length)
            emit = on_path & (o >= 0) & (pos >= row_emit[act])
            if emit.any():
                sel = np.nonzero(emit)[0]
                out_rows.append(rows[act[sel]])
                out_end.append(pos[sel] + 1)
                out_start.append(ps[act[sel]])
                out_pid.append(o[sel])
            if not on_path.all():
                act = act[on_path]
        if not out_rows:
            z = np.zeros(0, np.int64)
            return z, z, z
        r = np.concatenate(out_rows)
        e = np.concatenate(out_end)
        st = np.concatenate(out_start)
        pid = np.concatenate(out_pid)
        order = np.lexsort((st, e, r))  # (row, end, start): longest-first
        docs = packed.doc_id[r[order]].astype(np.int64)
        ends = packed.global_off[r[order]] + e[order]
        return docs, ends, pid[order].astype(np.int64)

    def verify(
        self,
        packed: PackedRows,
        start_idx: np.ndarray,
        n_cand: int,
    ) -> Iterator[Tuple[int, int, np.ndarray]]:
        """Iterator facade over :meth:`verify_arrays`."""
        return _records_iter(*self.verify_arrays(packed, start_idx, n_cand))


def _records_iter(docs, ends, pids) -> Iterator[Tuple[int, int, np.ndarray]]:
    """``(doc, end_pos, pattern_ids)`` a record, in order."""
    for i in range(docs.shape[0]):
        yield int(docs[i]), int(ends[i]), pids[i : i + 1]
