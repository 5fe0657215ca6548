#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving paths on one CUDA card and check
them.

Run from the repository root:  python3 chip_smoke.py
(``--parent CSRC`` also times another checkout's ``bloom_word_vmem``,
built from its ``csrc`` directory, beside this tree's.)

Phases (any failure exits non-zero; nothing is caught and passed over):

1. build every CUDA kernel from ``php_aho_corasick_tpu_torch/csrc`` with
   nvcc for sm_90a (one nvcc per source, all started together);
2. hold each kernel against its plain PyTorch version on the same CUDA
   tensors, bit for bit: random tables (the fused filter with shorts and
   pack=1; the tile scan with int16 and int32 tables up to 4096 entries,
   short and empty rows, ragged B and L), then each path's real tables at
   its corpus shape;
3. the cascade path at the reference benchmark's size (``bench.py``): 2048
   needles x 16 bytes over ``abcdef``, a 128 MiB resident corpus,
   ``Matcher.device_corpus`` -> ``match_arrays`` warm-up ->
   ``match_arrays_many([handle] * 12)`` timed with CUDA events; the
   kernels' launch counters are zeroed just before and read just after;
   the dispatch half is then run again under
   ``torch.cuda.set_sync_debug_mode("error")``;
4. a 64 MiB corpus with needles planted at 1e-5 per byte: results equal a
   host numpy DFA walk on an 8 MiB slice, and every planted needle found;
5. the tile path: ``benchmarks/probe_tile_tpu.py``'s 40 short patterns
   over ``a-f`` (184 states x 7 classes) against 32 MiB of the same base
   documents, ``device_corpus`` -> ``match_arrays`` timed with CUDA
   events and counted as in 3; its records against the host walk (8 MiB),
   the dense engine (all 32 MiB), a run at the default match capacity
   (retries) and ``match_many``'s dicts; the PHP-parity functions on the
   reference's test1 input;
6. the rows path: 2048 needles x 13 bytes over ``abcdef`` (plan q=9,
   stride 5: the per-row filter on ``bloom_word_vmem``) against the
   headline's 128 MiB, ``match_arrays_many([handle] * 12)`` timed, counted
   and sync-checked as in 3; the kernel on the plan's table at this shape,
   with its parts (a table of zeros, a table of ones) and its profiler
   device time (beside another checkout's with ``--parent CSRC``); a
   64 MiB copy with needles planted at 1e-5 (all found, 8 MiB equal to the
   host walk);
7. the anchored path: 2048 needles x 7 bytes over ``abcdef`` (anchored
   plan, q=7, one 2^17-bit stage) with ``engine="cascade"`` against 32 MiB
   of the base documents: ``match_arrays(handle)`` timed, its ``bloom_hit``
   launches counted, and one pass split into device filter, fetch and host
   verify; equal to the dense engine on all 32 MiB and to the host walk on
   8 MiB; the kernel against ``bloom_hit_take`` at this shape;
8. the take filters: take-flat, 16,384 needles x 16 bytes over
   ``abcdef`` at the default config (plan q=10, stride 7, no bank bloom,
   a 2^27-word positional bloom) against the headline's 128 MiB,
   ``match_arrays_many([handle] * 12)`` timed, traced and sync-checked,
   never reaching the host verify (the needles are drawn apart from the
   base documents, which hold only chance occurrences of them), planted
   needles at 64 MiB; the flat take filter's kernel
   (``flat_take_extract``) launched once a chain, its launch of one filter
   call held against its plain version and timed beside it and its bound
   (``portbench.bounds.sampled_filter_work``), and the same at one
   chromosome of the genome cell (31,496 rows of 4,224 ACGT bytes, q 15,
   stride 6, a 2^28-word bloom);
   take-grouped, the headline set with ``bloom_impl="take"`` on the
   headline's handle, timed with the launches of the grouped filter's two
   kernels counted (``grouped_take_extract``, ``grouped_take_refine``),
   equal to the fused route, every launch of one filter call held against
   its plain version, each kernel timed beside its plain version and its
   bound, the filter's device ms and operations a call on the kernels and
   on their plain versions in turns, planted needles;
   force-take, ``b"abcdefabcdefabcd" * 70000`` (more than 128 survivors
   in every extraction group): all 70,000 records, the matcher switched
   to the flat take filter and still serving;
9. the compressed table, the flagged-window verify and the k-gram engine:
   (a) signature-byte, ``benchmarks/bench_signatures.py --alphabet
   byte``'s draw at its full 1M needles, 16 random bytes each, built by
   the native (C++) builder at the default config: finalize to the
   compressed table (the dense one would pass ``dense_table_max_bytes``),
   build, plan and upload seconds and the card's peak memory printed, its
   64 MiB corpus of random bytes in 1 MiB documents with 200 needles
   planted,
   ``match_arrays_many([handle] * 12)`` timed, counted, traced and
   sync-checked, every planted needle found, 8 MiB equal to a host walk
   through ``CompressedAutomaton.lookup``, the grouped filter's kernels
   held and timed as in 8;
   (b) headline-compressed, the headline set with
   ``table_format="compressed"`` on phase 4's planted 64 MiB handle (the
   fused records chain with the compressed walk), timed, equal to the dense
   matcher; (c) ``engine="dfa"`` on (a)'s matcher (the compressed walk)
   over 8 MiB, equal to (a)'s records; (d) ``CascadeModel.launch_device``
   (the flagged-window verify) on (b)'s dense and compressed models over
   the 64 MiB handle, its ``emit_windows_arrays`` equal to the records
   path; (e) ``engine="kgram"`` (k = 4) on phase 5's 32 MiB tile handle,
   timed, equal to the tile and dense engines;
10. serving and streaming on the headline set: (a) ``match_arrays`` over
   the headline's 128 MiB as 16,384 fresh 8 KiB documents (the cold-corpus
   pipeline, 8 slices of 16 MiB) timed in turns with the pipeline off and
   with ``device_corpus`` + ``match_arrays``, and over phase 4's planted
   documents, equal to its records; (b) ``match_arrays_stream`` over 6
   batches of ``[handle] * 2`` (headline, planted), each equal to
   ``match_arrays_many``, timed in turns against 6 sequential calls, its
   dispatch under ``set_sync_debug_mode("error")``; (c) one stream over the
   planted 64 MiB in 4 MiB feeds (the prefix re-scan through the cascade),
   a needle planted across every feed boundary, all found at their global
   offsets, 8 MiB equal to the host walk; (d) the dense device carry on
   the tile cell's automaton over 8 MiB in 1 MiB feeds, ``Matcher.match``
   replaced by a raiser, equal to the host walk; (e) ``iter_matches`` over
   (c)'s bytes, equal to its records, and ``find_all=False`` stopping after
   the first segment with a match; (f) ``replace`` and ``replace_stream``
   (NORMAL and LAZY) over (c)'s bytes, the stream equal to the one-shot
   call and NORMAL equal to a splice of (c)'s records; (g) ``warmup`` and
   one ``match_many`` at its shape;
11. the data mesh, 4 shards of the card (``parallel.mesh.local_shards``):
   (a) the headline's 128 MiB through ``device_corpus(shard=True)`` and
   ``match_arrays_many([handle] * 12)``, records equal to the unsharded
   handle's, per-shard record counts equal to a host split of them, ms a
   pass by CUDA events in turns with the unsharded handle, launches a pass
   by trace, no host sync in the sharded dispatch; (b) phase 4's planted
   64 MiB sharded, every planted needle found, records equal to phase 4's,
   per-shard record counts equal to a host split of them (the headline
   holds no match);
   (c) ``match_arrays`` sharded through the tile, dfa, k-gram, anchored,
   rows, take-flat, take-grouped, headline-compressed and signature-byte
   cells, each equal to its unsharded records, the compressed table held
   once on the card; (d) ``parallel.dryrun.dryrun_multichip(4, "cuda")``;
   (e) two processes on the card (``torch.distributed`` with gloo, both
   ranks on ``cuda:0``, the script run again with ``--worker``) over 16
   MiB with needles planted at 1e-5, both equal to the single-process
   records.  Every launch of (a)'s first call and of the cells of (c)
   that run a filter kernel or the tile kernel, at a shard's shape, is
   held against its plain version;
12. the remaining surface: (a) the headline set built by the native and
   the numpy builder, bit-equal tables, the library under
   ``build/torch_kernels/``; (b) ``utils.serialization``: the 1M
   signature-byte matcher saved and loaded onto the card (file size, save
   and load seconds beside the native build's), its 64 MiB served equal to
   9a's records, and a dense round trip of the headline matcher served
   over phase 4's planted handle equal to its records; (c)
   ``utils.profiling.trace`` around one headline pass (the trace names the
   fused kernel) and ``sync``; (d) the command line in subprocesses on the
   card (``scan``, ``build``, ``info``, ``replace``) with the tile probe
   set over 1 MiB of the base documents, equal to the same calls in
   process; (e) the three examples at their default sizes.  Every launch
   of the loaded matchers' passes in (b), of (d)'s scan in process and of
   (e)'s ``bulk_scan`` is held against its plain version;
13. a fixed slice of the randomized soak (``python -m
   php_aho_corasick_tpu_torch.soak``, ``SOAK_CASES`` cases at
   ``SOAK_SEED`` in a subprocess): random needle sets, documents and
   configs through ``match_many`` against brute force, 0 mismatches, the
   slice's scans and skips, every hand kernel launched by the cases and
   every launch bit-equal to its plain version on the same inputs (their
   launches and differences are added to the kernel line);
14. (a) the hex signature set at 1M needles in process (the signatures
   tool's draw: the dense table, the take-grouped filter), a pass counted
   and its plants found, the grouped filter's kernels held and timed as
   in 8; then the measurement tools (``python -m
   php_aho_corasick_tpu_torch.bench.*``, each a subprocess that holds
   every kernel launch of one untimed pass against its plain version
   first): the headline record and the stage budget at full size, the
   scaling record (the sharded cascade on 4 shards of the card, 32 MiB),
   the PHP protocol (2 samples), and first the hex signature set at 1M
   needles (the grouped kernels); each record holds the reference's keys, its matches
   (the headline's none, each density row's equal to a host walk of its
   planted corpus, the protocol's equal to a window count of its draws,
   all 200 signature plants), stage rows within the public pass, and
   every held launch bit-equal to the plain version (the launches are
   added to the kernel line);
15. one JSON line of kernel timings, the card's name and power limit, and
   the last line ``{"ok": true, "device": {...}}``.

Phases 9c and 11c run on the 1M-needle matcher of 9a too.

Phase 2 also holds ``bloom_word_vmem`` (pack 1/2/4, k 1-8, 2^12-2^15-word
tables, some over the shared-memory budget, ragged code counts down to 1,
code views 1-3 elements past a 16-byte boundary, tables of zeros and of
ones), ``bloom_hit`` (blooms of 2^15-2^20 bits) and the grouped take
filter's two kernels (strides 4-32, q 1-16, 1-8 salts, the second code
family, shorts, ``min_long_len`` 0, groups of 32-1024 rows, prefix off and
on) and the records verify (``VERIFY_CASES``: 4-48 used bytes, int16,
int32 and 2-step tables, strides 3-12, padding, capacities under the
record count) against their plain versions.  Phases 3, 4, 8 (take-flat)
and 9a (signature-byte) also hold every records-verify launch of one
call against its plain version and time the kernel there beside it and
its bytes floor, at the call's capacity and at half the record count;
every path launches it once a chain, counted with the other kernels.  The
kernel line lists eight kernels: the four that replace the JAX package's
Pallas kernels and the grouped take filter's two, the records verify and
the flat take filter's, which replace XLA code of its ``filter_jax.py``.
"""

import contextlib
import inspect
import json
import random
import subprocess
import sys
import time

import numpy as np

from portbench.bounds import bound_of

N_NEEDLES, NEEDLE_LEN = 2048, 16
ALPHABET = b"abcdef"
DOC_BYTES, N_BASE_DOCS = 8192, 256  # bench.py's 2 MiB pass
HEADLINE_REPS = 64  # 128 MiB resident corpus
DENSITY_REPS, DENSITY = 32, 1e-5  # 64 MiB, planted matches per byte
BATCH = 12
TILE_REPS, TILE_PASSES, DFA_PASSES = 16, 10, 2  # 32 MiB tile corpus
TILE_CAPACITY = 1 << 19  # every final position of a pass in one scan
ROWS_LEN = 13  # needle bytes of the rows path (plan stride 5)
ANCHORED_LEN, ANCHORED_REPS, ANCHORED_PASSES = 7, 16, 3  # 32 MiB
TAKE_NEEDLES = 16384  # the smallest measured set with no bank bloom is 8192
# one chromosome of the genome cell's flat take filter (crispr-gecko2-grch38:
# 129 MB in rows of 4,224 bytes, a 2^28-word bloom), and the share of its
# bloom's words that are live: ~1.2e-3 hits a byte, the cell's density
GENOME_ROWS, GENOME_ROW_LEN, GENOME_LOG2_WORDS = 31496, 4224, 28
GENOME_LIVE = 0.007
FORCE_TAKE_NEEDLE, FORCE_TAKE_REPS = b"abcdefabcdefabcd", 70000
# bench_signatures.py --alphabet byte at its full 1M needles
SIG_NEEDLES, SIG_LEN, SIG_MIB, SIG_DOC = 1_000_000, 16, 64, 1 << 20
KGRAM_PASSES = 3
# phase 10: fresh-corpus passes, stream batches, feed sizes, warmup shape
FRESH_PASSES, STREAM_BATCHES = 3, 6
STREAM_FEED, CARRY_FEED, CARRY_BYTES = 4 << 20, 1 << 20, 8 << 20
WARMUP_DOC, WARMUP_DOCS = 1 << 20, 16
DEVICE = "cuda"


def log(*args):
    print(*args, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def workload(seed=1337):
    """bench.py's headline needles and 2 MiB of base documents."""
    rng = random.Random(seed)
    needles = set()
    while len(needles) < N_NEEDLES:
        needles.add(bytes(rng.choice(ALPHABET) for _ in range(NEEDLE_LEN)))
    needles = sorted(needles)
    base = np.frombuffer(
        bytes(rng.choice(ALPHABET) for _ in range(DOC_BYTES * N_BASE_DOCS)),
        np.uint8,
    ).reshape(N_BASE_DOCS, DOC_BYTES)
    return needles, base


def cuda_ms(fn, reps):
    """Device ms per call of ``fn``: the card first sleeps ~1 ms a call,
    so the host has queued every launch before the timed ones start and
    the host's own time per call (~0.1 ms in a wrapper) is not counted."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e6) * reps)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def profiler_ms(torch, fn, reps, name):
    """Device ms per launch of the kernels whose name holds ``name``, by
    ``torch.profiler`` over ``reps`` calls of ``fn`` (``None`` when the
    profiler saw none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        if name in e.key:
            t = getattr(e, "self_device_time_total", None)
            total += t if t is not None else e.self_cuda_time_total
            count += e.count
    return total / 1e3 / count if count else None


def parent_bloom_word_vmem(csrc):
    """``bloom_word_vmem`` of another checkout, built from its ``csrc``
    directory (``--parent``) with this tree's nvcc flags: its C entry
    point takes the same arguments, so it runs on the same tensors.
    Returns ``run(table, codes, salts, log2_rows, pack)``."""
    import ctypes
    from pathlib import Path

    import torch

    from php_aho_corasick_tpu_torch.ops import _build
    from php_aho_corasick_tpu_torch.ops.filter_cuda import (
        BLOOM_WORD_VMEM_ARGTYPES, _u32_array,
    )

    src = Path(csrc) / "bloom_word_vmem.cu"
    out = _build.BUILD_DIR / "parent" / "libbloom_word_vmem.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc),
                    "-o", str(out), str(src)], check=True)
    fn = ctypes.CDLL(str(out)).bloom_word_vmem_launch
    fn.argtypes = BLOOM_WORD_VMEM_ARGTYPES["bloom_word_vmem_launch"]
    fn.restype = ctypes.c_int

    def run(table, codes, salts, log2_rows, pack):
        res = torch.empty_like(codes)
        rc = fn(table.data_ptr(), table.numel(), codes.data_ptr(),
                res.data_ptr(), codes.numel(), _u32_array(salts, len(salts)),
                len(salts), log2_rows, pack,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"parent bloom_word_vmem: CUDA error {rc}")
        return res

    return run


def compare(got, want, what):
    """Max abs difference of the kernel's outputs (a tensor or a tuple)
    from the plain version's; raises unless they are equal bit for
    bit."""
    if not isinstance(got, (tuple, list)):
        got, want = [got], [want]
    err = 0
    for i, (a, b) in enumerate(zip(got, want)):
        if a.shape != b.shape:
            raise AssertionError(f"{what}: output {i} shape {a.shape} != "
                                 f"{b.shape}")
        d = int((a.long() - b.long()).abs().max().item()) if a.numel() else 0
        if d or a.dtype != b.dtype:
            raise AssertionError(
                f"{what}: kernel output {i} differs from the plain version "
                f"(max abs err {d}, dtypes {a.dtype} {b.dtype})"
            )
        err = max(err, d)
    return err


def extract_args(cm, dc):
    """The fused kernel's arguments exactly as the records chain builds
    them for this corpus handle (``CascadeModel.fused_extract_args``)."""
    return cm.fused_extract_args(dc.chunks_d, dc.lengths_d,
                                 dc.fused_phases(cm))


def held_calls(fn, *names):
    """Run ``fn()`` with every hand-kernel launch held against its plain
    version on the same inputs (``soak.held_to_plain``; any difference
    raises) and the calls of the kernels ``names`` kept.  Returns
    ``fn()``'s result and those calls by name, ``[(args, kwargs,
    output)]``, each kernel launched at least once."""
    from php_aho_corasick_tpu_torch.ops._build import observed
    from php_aho_corasick_tpu_torch.soak import held_to_plain

    kept = {name: [] for name in names}

    def keep(kernel, args, kw, out):
        if kernel.name in kept:
            kept[kernel.name].append((args, kw, out))

    with held_to_plain() as err, observed(keep):
        res = fn()
    assert not any(err.values()), f"differs from its plain version: {err}"
    for name, calls in kept.items():
        assert calls, f"{name} was not launched"
    return res, kept


def launch_counts(since=None):
    """The hand kernels' launches by name, less ``since``'s
    (``ops/_build.launch_counts``)."""
    from php_aho_corasick_tpu_torch.ops import _build

    return _build.launch_counts(since)


def launched_only(launched, what, least, *names):
    """Assert that of the hand kernels only ``names`` launched, each at
    least ``least`` times."""
    assert all(launched[n] >= least for n in names), (what, launched)
    assert not any(n for k, n in launched.items() if k not in names), (
        f"{what} launched other kernels: {launched}")


def in_ms(bound):
    """A ``portbench.bounds.bound_of`` bound as ``(ms, by, bytes, ops)``."""
    return bound["seconds"] * 1e3, bound["by"], bound["bytes"], bound["ops"]


def salt_probes(table, code, salts, log2_rows, pack):
    """Salted table probes the bank-bloom AND makes on these codes
    (``code`` unsigned in int64) when it stops at the first zero."""
    import torch

    from php_aho_corasick_tpu_torch.ops.filter_cuda import _bank_probe_torch

    probes = torch.zeros(code.shape, dtype=torch.int64, device=code.device)
    alive = torch.ones(code.shape, dtype=torch.bool, device=code.device)
    acc = None
    per_salt = table.reshape(len(salts), -1)
    for p, salt in enumerate(salts):
        probes += alive
        w = _bank_probe_torch(per_salt[p], code, (salt,), log2_rows, pack)
        acc = w if acc is None else acc & w
        alive = acc != 0
    return int(probes.sum().item())


def hit_bound(words, slots):
    """``bound_of`` the bit test: each slot read and each result written
    once (4 bytes each), and the bloom's words read once, but no more of
    them than there are slots (a slot reads one word); ~5 operations a
    slot (the word index, the load, the shift, the mask, the store)."""
    return bound_of(slots.numel() * 8 + min(words.numel(), slots.numel()) * 4,
                    5 * slots.numel())


def assert_no_sync(torch, fn):
    """Run ``fn`` under ``set_sync_debug_mode("error")``: any host
    synchronisation raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def fused_bound(args, kw, out):
    """Least time for the fused filter on these inputs: each input read
    and each output written once over the memory rate, against the
    integer operations this data needs over the int32 rate: the q-gram
    code (one dp4a per weight byte plane of each of its ceil(q/4) words,
    then 3 shifts and 3 adds to join the four planes) and the salted
    probes until the AND reaches zero, ~12 each (hash, address, load,
    sub-word, AND).  The hit test, rank scan and slot writes are left
    out, so this stays a floor."""
    import torch

    from php_aho_corasick_tpu_torch.ops.filter_torch import (
        GRAM_BASE, U32_MASK, u32,
    )

    table, phase_g, _, mll = args
    n_bytes = sum(t.numel() * 4 for t in (table, phase_g, mll,
                                           kw["prefix_table"]))
    n_bytes += sum(t.numel() * 4 for t in out)
    n = kw["n_grid"]
    spc, q = kw["spc"], kw["q"]
    flat = phase_g.reshape(spc, -1)
    code = torch.zeros(n, dtype=torch.int64, device=table.device)
    for j in range(q):
        c, k = divmod(j, 4)
        word = flat[c % spc, c // spc : c // spc + n]
        code = (code + ((u32(word) >> (8 * k)) & 0xFF)
                * pow(GRAM_BASE, q - 1 - j, 1 << 32)) & U32_MASK
    probes = salt_probes(table, code, kw["salts"], kw["log2_rows"],
                         kw["pack"])
    return bound_of(n_bytes, n * (4 * -(-q // 4) + 6) + 12 * probes)


def phase_kernel_random(torch, fse):
    rng = np.random.default_rng(0)
    k, log2_rows, pack, spc, n_blocks = 3, 12, 1, 2, 8
    R_pad = n_blocks * 1024
    n_banks = (1 << log2_rows) // 128
    table = rng.integers(0, 2**31, (k * n_banks // pack, 128)).astype(np.int32)
    phases = rng.integers(-(2**31), 2**31, (spc, R_pad + 8, 128),
                          dtype=np.int64).astype(np.int32)
    sw = (rng.integers(0, 2**31, (R_pad, 128))
          * (rng.random((R_pad, 128)) < 0.01)).astype(np.int32)
    salts = tuple((0x9E3779B9 * (2 * i + 1)) & 0xFFFFFFFF for i in range(k))
    c = lambda x: torch.from_numpy(x).to(DEVICE)  # noqa: E731
    args = (c(table), c(phases), c(sw),
            torch.ones((1, 1), dtype=torch.int32, device=DEVICE))
    kw = dict(salts=salts, log2_rows=log2_rows, pack=pack, q=9, spc=spc,
              mpr=16, block_r=1024, n_grid=R_pad * 128 - 555, l16=0,
              prefix_on=False, prefix_table=None, prefix_salts=(),
              prefix_log2=0)
    got = fse(*args, **kw)
    want = fse.plain(*args, **kw)
    torch.cuda.synchronize()
    err = compare(got, want, "random tables, shorts, pack=1")
    return int(got[4].sum().item()), err


def phase_fused_cases(torch, fse):
    """The fused kernel against its plain version over spc 1-4 x pack
    1/2/4 x q 1/9/16 (prefix on and off, shorts on and off), tables over
    the shared-memory budget; returns ``(cases, max_abs_err)``."""
    rng = np.random.default_rng(4)
    cases = [(3, 11, pack, spc, q, spc % 2 == 1, (spc + q + pack) % 2 == 0)
             for spc in (1, 2, 3, 4) for pack in (1, 2, 4) for q in (1, 9, 16)]
    cases += [
        (4, 13, 1, 2, 9, True, True),  # 128 KiB of tables: read from L2
        (8, 13, 1, 2, 9, False, True),  # 256 KiB
        (5, 14, 1, 3, 16, True, False),  # 320 KiB, four words a code
    ]
    c = lambda x: torch.from_numpy(x).to(DEVICE)  # noqa: E731
    n_blocks, err = 3, 0
    R_pad = n_blocks * 1024
    ptab = c(rng.integers(-(2**31), 2**31, (8, 128), dtype=np.int64)
             .astype(np.int32))
    for k, log2_rows, pack, spc, q, shorts, prefix in cases:
        table = c(random_bank_table(rng, k, log2_rows, pack))
        phases = c(rng.integers(-(2**31), 2**31, (spc, R_pad + 8, 128),
                                dtype=np.int64).astype(np.int32))
        sw = c((rng.integers(0, 2**31, (R_pad, 128))
                * (rng.random((R_pad, 128)) < 0.01)).astype(np.int32))
        args = (table, phases, sw if shorts else None,
                torch.ones((1, 1), dtype=torch.int32, device=DEVICE))
        salts = tuple((0x9E3779B9 * (2 * i + 1)) & 0xFFFFFFFF
                      for i in range(k))
        kw = dict(salts=salts, log2_rows=log2_rows, pack=pack, q=q, spc=spc,
                  mpr=16, block_r=1024, n_grid=R_pad * 128 - 777,
                  l16=12 if prefix else 0, prefix_on=prefix,
                  prefix_table=ptab if prefix else None,
                  prefix_salts=(0x7F4A7C15, 0x94D049BB) if prefix else (),
                  prefix_log2=15 if prefix else 0)
        want = fse.plain(*args, **kw)
        got = fse(*args, **kw)
        torch.cuda.synchronize()
        err = max(err, compare(got, want, (
            f"fused k={k} 2^{log2_rows} pack={pack} spc={spc} q={q} "
            f"shorts={shorts} prefix={prefix}")))
        assert int(want[4].sum()) > 0, "no hits"
    return len(cases), err


def random_bank_table(rng, k, log2_rows, pack):
    """Bank tables whose k-salt AND is zero for about half the codes."""
    rows = k * ((1 << log2_rows) // 128) // pack
    # a sub-word of 32/pack bits, each set after the AND at 0.7/(32/pack)
    bits = rng.random((rows, 128, 32)) < (0.7 / (32 // pack)) ** (1.0 / k)
    words = (bits * (1 << np.arange(32, dtype=np.uint64))).sum(-1)
    return words.astype(np.uint32).view(np.int32)


def phase_bloom_random(torch, bwv, bh):
    """``bloom_word_vmem`` and ``bloom_hit`` against their plain versions
    on random tables; returns ``(cases, max_abs_err)`` of each."""
    from php_aho_corasick_tpu_torch.ops.filter_cuda import _bank_probe_torch
    from php_aho_corasick_tpu_torch.ops.filter_torch import (
        bloom_hit_take, u32,
    )

    rng = np.random.default_rng(2)
    c = lambda x: torch.from_numpy(x).to(DEVICE)  # noqa: E731
    vmem_cases = [
        # k, log2_rows, pack, n, codes' offset from 16 bytes, table fill
        (2, 12, 4, 1000, 0, None),
        (8, 12, 4, 3 * 4097 + 5, 0, None),
        (3, 13, 2, 777_777, 0, None),
        (2, 12, 1, 128, 0, None),  # 32 KiB in shared memory
        (5, 14, 1, 100_003, 0, None),  # 320 KiB: over the budget, from L2
        (8, 15, 4, 12_345, 0, None),  # 256 KiB: over the budget
        (7, 15, 2, 2_000_001, 0, None),
        # n of 1, 3 and 4m + 1, views 1-3 elements past 16 bytes (the
        # wrapper's output lies at the same offset)
        (7, 12, 4, 1, 1, None),
        (7, 12, 4, 3, 2, None),
        (7, 12, 4, 4 * 100_003 + 1, 1, None),
        (7, 12, 4, 4 * 100_003 + 1, 2, None),
        (7, 12, 4, 4 * 100_003 + 1, 3, None),
        (5, 14, 1, 4 * 9_999 + 1, 3, None),  # misaligned, from L2
        # k = 1 and 8
        (1, 12, 4, 4 * 50_000 + 1, 1, None),
        (8, 12, 4, 4 * 50_000 + 1, 2, None),
        (1, 15, 1, 4 * 5_000 + 3, 0, None),
        (8, 12, 1, 4 * 5_000 + 3, 3, None),
        # a table of zeros (every AND ends after the first probes) and one
        # of ones (every code takes all k probes)
        (7, 12, 4, 4 * 100_003 + 1, 1, 0),
        (7, 12, 4, 4 * 100_003 + 1, 2, -1),
        (8, 13, 2, 4 * 10_007 + 2, 0, -1),
        (8, 15, 4, 4 * 10_007 + 3, 3, -1),  # ones, over the budget
    ]
    err_v = 0
    for k, log2_rows, pack, n, off, fill in vmem_cases:
        salts = tuple((0x9E3779B9 * (2 * i + 1)) & 0xFFFFFFFF
                      for i in range(k))
        table = random_bank_table(rng, k, log2_rows, pack)
        if fill is not None:
            table[:] = fill
        table = c(table)
        codes = c(rng.integers(-(2**31), 2**31, n + off, dtype=np.int64)
                  .astype(np.int32))[off:]
        assert codes.data_ptr() % 16 == 4 * off
        got = bwv(table, codes, salts, log2_rows, pack)
        want = _bank_probe_torch(table, u32(codes), salts, log2_rows, pack)
        torch.cuda.synchronize()
        what = (f"bloom_word_vmem k={k} 2^{log2_rows} rows pack={pack} n={n} "
                f"offset={off} fill={fill}")
        assert got.data_ptr() % 16 == 4 * off, what
        err_v = max(err_v, compare([got], [want], what))
        n_set = int((got != 0).sum())
        if fill is None:
            assert 0 < n_set < n or n < 200, f"degenerate table: {what}"
        else:
            assert n_set == (n if fill else 0), what
    bloom_cases = [(15, 1000), (17, 3_000_001), (18, 333), (19, 65_537),
                   (20, (1 << 20) + 3)]
    err_h = 0
    for log2_bits, n in bloom_cases:
        words = c(rng.integers(-(2**31), 2**31, (1 << log2_bits) // 32,
                               dtype=np.int64).astype(np.int32))
        slots = c(rng.integers(0, 1 << log2_bits, n).astype(np.int32))
        got = bh(words, slots)
        want = bloom_hit_take(words, slots)
        torch.cuda.synchronize()
        err_h = max(err_h, compare([got], [want],
                                   f"bloom_hit 2^{log2_bits} bits n={n}"))
    return len(vmem_cases), err_v, len(bloom_cases), err_h


def phase_grouped_random(torch, gte, gtr):
    """The grouped take filter's two kernels against their plain versions
    on random inputs made on the card from a seeded generator: strides
    4-32 (words past a cell, alignment bit 31), q 1-16, 1-8 salts, the
    second code family, short words, ``min_long_len`` 0, groups of 32-1024
    rows, columns with more hits than slots, and the refinement of each
    case's compaction with the prefix bloom off and on (1-3 salts, windows
    of 4-20 bytes, fewer entries than hits).  Returns ``(cases,
    max_abs_err)``."""
    from php_aho_corasick_tpu_torch.ops.filter_torch import (
        blocked_nonzero, to_i32,
    )

    cases = [
        # stride, q, k, dual, shorts, block_r, mpr, B, M, log2_words,
        # density, mll, prefix_len, prefix salts, prefix_log2, capacity
        (8, 9, 2, False, False, 1024, 24, 33, 256, 13, 0.02, 1, 12, 2, 15,
         4096),
        (12, 5, 2, True, False, 256, 8, 17, 341, 14, 0.05, 1, 4, 1, 17, 4096),
        (16, 16, 3, False, True, 128, 16, 40, 100, 12, 0.01, 1, 16, 2, 20, 64),
        (32, 9, 1, False, True, 512, 128, 9, 1000, 13, 0.3, 1, 20, 2, 15,
         4096),
        (4, 9, 2, False, False, 100, 8, 50, 64, 13, 0.05, 1, 9, 3, 16, 1024),
        (20, 13, 4, True, True, 1000, 40, 7, 999, 15, 0.02, 1, 0, 0, 0, 4096),
        (8, 1, 8, False, True, 32, 8, 3, 77, 10, 0.1, 1, 12, 2, 15, 512),
        (8, 9, 2, True, True, 1024, 24, 33, 256, 13, 0.02, 0, 12, 2, 15,
         4096),
    ]
    err = 0
    for i, (stride, q, k, dual, shorts, block_r, mpr, B, M, log2_words,
            dens, mll, plen, n_ps, plog2, cap) in enumerate(cases):
        g = torch.Generator(device=DEVICE).manual_seed(i)

        def ints(*shape):
            return torch.randint(-(2**31), 2**31, shape, generator=g,
                                 dtype=torch.int64, device=DEVICE
                                 ).to(torch.int32)

        def sparse(p, x):
            u = torch.rand(x.shape, generator=g, device=DEVICE)
            return torch.where(u < p, x, 0)

        n = 1 << log2_words
        one = torch.randint(0, stride, (n,), generator=g, device=DEVICE)
        bits = torch.where(torch.rand(n, generator=g, device=DEVICE) < 0.5,
                           torch.ones_like(one) << one,
                           (ints(n).long() & ((1 << stride) - 1)) | 1)
        words, wc = sparse(dens, to_i32(bits)), ints(B, M * stride // 4)
        sw = sparse(0.01, ints(B, M)) if shorts else None
        words2 = sparse(0.5, ints(n)) if dual else None
        mll_t = torch.tensor(mll, dtype=torch.int32, device=DEVICE)
        salts = tuple((0x9E3779B9 * (2 * j + 1)) & 0xFFFFFFFF
                      for j in range(k))
        kw = dict(q=q, spc=stride // 4, log2_words=log2_words, salts=salts,
                  mpr=mpr, block_r=block_r)
        got = gte(words, wc, sw, mll_t, words2, **kw)
        want = gte.plain(words, wc, sw, mll_t, words2, **kw)
        torch.cuda.synchronize()
        what = (f"grouped_take_extract stride {stride} q {q} k {k} words2 "
                f"{dual} shorts {shorts} block_r {block_r} mpr {mpr}")
        err = max(err, compare(got, want, what))
        assert int(got[4].sum()) > 0, what
        r_s, w_s, swo_s = got[:3]
        slot, _ = blocked_nonzero(
            ((r_s >= 0) & ((w_s | swo_s) != 0)).reshape(-1), cap)
        pw = ints((1 << plog2) // 32) if plen else None
        kw = dict(mpr=mpr, block_r=block_r, spc=stride // 4,
                  prefix_salts=salts[:n_ps], prefix_log2=plog2,
                  prefix_len=plen)
        got = gtr(slot, r_s, w_s, swo_s, wc, pw, **kw)
        want = gtr.plain(slot, r_s, w_s, swo_s, wc, pw, **kw)
        torch.cuda.synchronize()
        err = max(err, compare(got, want, f"grouped_take_refine after "
                                          f"{what}, prefix_len {plen}"))
    return len(cases), err


def trace_breakdown(torch, run, card, passes=2, top=8):
    """Device time by kernel over ``passes`` traced passes (``run(passes)``
    runs them; torch.profiler), and the device's busy share of the traced
    window."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        run(passes)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - w0) * 1e3
    rows = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = getattr(e, "self_cuda_time_total", 0)
            rows.append((t / 1e3 / passes, e.count // passes, e.key))
    busy = sum(r[0] for r in rows)
    if busy <= 0:
        log("trace: device time not measured (the profiler saw no kernels)")
        return None
    rows.sort(reverse=True)
    n_launch = sum(r[1] for r in rows)
    log(f"trace of {passes} passes: device busy {busy:.3f} ms/pass of "
        f"{wall_ms / passes:.3f} ms/pass traced wall "
        f"({100 * busy * passes / wall_ms:.1f}% busy), "
        f"{n_launch} kernel launches/pass, on {card}")
    for t, n, name in rows[:top]:
        log(f"  {t:9.4f} ms/pass  {n:5d}x  {name[:90]}")
    return busy, n_launch


def host_walk(auto, docs):
    """Reference-order matches of equal-length documents by a host numpy
    DFA walk over the port's own automaton: (doc, end, pattern) rows."""
    from php_aho_corasick_tpu_torch.ops.matches import csr_expand

    cls = auto.byte_class[docs]
    states = np.zeros(docs.shape[0], np.int64)
    rows = []
    for t in range(docs.shape[1]):
        states = auto.lookup(states, cls[:, t])
        fin = np.nonzero(auto.is_final(states))[0]
        if fin.size:
            rec_of, pids = csr_expand(auto, states[fin])
            rows.append(np.stack([fin[rec_of], np.full(rec_of.shape, t + 1),
                                  pids]))
    arr = np.concatenate(rows, axis=1) if rows else np.zeros((3, 0), np.int64)
    order = np.lexsort((arr[1], arr[0]))  # stable: CSR order within an end
    return arr[:, order]


def planted_docs(needles, base, seed, reps=None):
    """The base documents replicated ``reps`` (default ``DENSITY_REPS``)
    times with ``needles`` planted at ``DENSITY`` per byte: the
    ``[n_docs, DOC_BYTES]`` array and the planted ``(doc, offset,
    pattern)`` rows."""
    length = len(needles[0])
    reps = DENSITY_REPS if reps is None else reps
    dens = np.repeat(base[None], reps, axis=0).reshape(-1, DOC_BYTES)
    prng = random.Random(seed)
    planted = []
    for _ in range(int(DENSITY * dens.size)):
        di = prng.randrange(dens.shape[0])
        off = prng.randrange(DOC_BYTES - length)
        pid = prng.randrange(len(needles))
        dens[di, off : off + length] = np.frombuffer(needles[pid], np.uint8)
        planted.append((di, off, pid))
    return dens, planted


#: the records verify kernel's random cases: used bytes, rows, row
#: length, stride, hit slots, capacity
VERIFY_CASES = [
    (4, 16, 256, 8, 256, 4096), (4, 16, 256, 8, 256, 48),
    (48, 64, 4096, 8, 2048, 4096), (6, 33, 1000, 5, 777, 100),
    (4, 8, 512, 12, 300, 8), (40, 5, 100, 3, 150, 64),
]


def phase_verify_random(torch, vr):
    """The records verify kernel against its plain version on random
    automata and corpora (``VERIFY_CASES``): 4-6 used bytes and 40-48
    (where the plain version's classes come from the ``byte_class``
    gather), the int16 and int32 dense tables and the 2-step table, strides 3-12,
    ragged row lengths and ``emit_from``, a run of one byte (windows with
    more finals than record slots), hit arrays with padding, ``n_hits``
    past the array, every slot padding, and capacities under the record
    count.  Returns ``(calls, max_abs_err)``."""
    from php_aho_corasick_tpu_torch.core import TrieBuilder, compile_trie
    from php_aho_corasick_tpu_torch.ops.filter_torch import REC2_BITS

    calls, err = 0, 0
    for seed, (n_alpha, B, L, stride, H, cap) in enumerate(VERIFY_CASES):
        rng = np.random.default_rng(seed)
        alphabet = np.arange(97, 97 + n_alpha, dtype=np.uint8)
        top = min(16, 32 - stride)
        patterns = list(dict.fromkeys(
            [rng.choice(alphabet, rng.integers(3, top + 1)).tobytes()
             for _ in range(40)] + [b"aaaa", b"aaaaa"]))
        tb = TrieBuilder(1024)
        for pat in patterns:
            tb.add(pat)
        auto = compile_trie(tb, [len(pat) for pat in patterns])
        chunks = rng.choice(alphabet, (B, L))
        for _ in range(4 * B):
            pat = patterns[rng.integers(len(patterns))]
            b, o = rng.integers(B), rng.integers(L - len(pat))
            chunks[b, o : o + len(pat)] = np.frombuffer(pat, np.uint8)
        chunks[0, 10:40] = ord("a")
        lengths = np.full(B, L, np.int32)
        lengths[1::3] = rng.integers(L // 2, L, len(lengths[1::3]))
        emit_from = np.zeros(B, np.int32)
        emit_from[2::4] = 11
        M = -(-L // stride)
        m0 = min(M, H // 2)
        cells = np.concatenate([np.arange(m0), rng.choice(
            np.arange(M, B * M), H - m0 - 20, replace=False)])
        drawn = np.full(H, 2**31 - 1, np.int32)
        drawn[: cells.shape[0]] = rng.permutation(cells)
        t = np.ascontiguousarray(auto.table, dtype=np.int64)
        S, C = t.shape
        table2 = (t[t.reshape(-1), :].reshape(S, C, C)
                  | (t[:, :, None] << REC2_BITS)).astype(np.int32)

        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(DEVICE)

        common = (put(auto.byte_class.astype(np.int32)),
                  put(auto.used_bytes), put(chunks), put(lengths),
                  put(emit_from))
        fs = torch.tensor(auto.final_start, dtype=torch.int32, device=DEVICE)
        kw = dict(n_classes=C, stride=stride,
                  win_len=stride - 1 + auto.max_len)
        for step, table in ((1, t.astype(np.int16)), (1, t.astype(np.int32)),
                            (2, table2)):
            for grid, n_hits in ((drawn, H), (drawn, H + 100),
                                 (np.full(H, 2**31 - 1, np.int32), H)):
                for capacity in (cap, 4096):
                    args = (put(table.reshape(-1)), *common, put(grid), fs)
                    k = dict(kw, capacity=capacity, n_hits=n_hits, step=step)
                    got = vr(*args, **k)
                    want = vr.plain(*args, **k)
                    err = max(err, compare(got, want, (
                        f"verify_records case {seed}, step {step}, "
                        f"{table.dtype}, n_hits {n_hits}, capacity "
                        f"{capacity}")))
                    calls += 1
    return calls, err


def verify_bound(args, kw, out):
    """``bound_of`` the records verify: a bytes floor only, each byte the
    launch must touch read or written once: the hit slots (4 bytes each);
    the corpus bytes the live slots' windows cover (windows overlap, so
    their union, cut at each row's end); the row length and ``emit_from``
    of each distinct row a live slot lies in (8 bytes); the table's
    entries, but no more of them than the walks gather (one a position,
    or a pair of positions on the 2-step table); the records and their
    count written once (8 bytes a capacity entry, 4).  The kernel's
    working bound is not this but each slot's ``win_len`` (or half as
    many) dependent L2 gathers of the table."""
    table, chunks, lengths, grid_idx = args[0], args[3], args[4], args[6]
    L = chunks.shape[1]
    H = min(kw["n_hits"], grid_idx.shape[0])
    g = grid_idx[:H].cpu().numpy().astype(np.int64)
    g = g[g < 2**31 - 1]
    stride, W = kw["stride"], kw["win_len"]
    M = -(-L // stride)
    b = g // M
    w0 = (g % M) * stride - (stride - 1)
    row_end = lengths.cpu().numpy().astype(np.int64)[b]
    lo = b * L + np.maximum(w0, 0)
    hi = b * L + np.minimum(w0 + W, row_end)
    order = np.argsort(lo, kind="stable")
    lo, hi = lo[order], hi[order]
    reach = np.maximum.accumulate(hi)  # the union's end so far
    before = np.concatenate([[np.iinfo(np.int64).min], reach[:-1]])
    window_bytes = int(np.maximum(hi - np.maximum(lo, before), 0).sum())
    gathers = g.shape[0] * -(-W // kw.get("step", 1))
    n_bytes = (4 * H + window_bytes + 8 * np.unique(b).shape[0]
               + min(table.numel(), gathers) * table.element_size()
               + 8 * out[0].numel() + 4)
    return bound_of(n_bytes, 0)


def verify_check(torch, card, what, run):
    """The records verify at one path's shapes (``run()``: one call of the
    path): every launch of the call held against the plain version on the
    same inputs; then, on the first launch's inputs, the kernel's ms (CUDA
    events) beside the plain version's and its bound, at the call's
    capacity and, when it made two records or more, at half their count
    (``n_rec > capacity``: the cut and the count), each held again.
    Returns the largest difference and the times by capacity."""
    from php_aho_corasick_tpu_torch.ops.filter_cuda import verify_records

    _, calls = held_calls(run, "verify_records")
    calls = calls["verify_records"]
    args, kw, out = calls[0]
    n_rec = int(out[2])
    caps = [kw["capacity"]] + ([n_rec // 2] if n_rec >= 2 else [])
    err, times = 0, {}
    for cap in caps:
        k = dict(kw, capacity=cap)
        got = verify_records(*args, **k)
        err = max(err, compare(got, verify_records.plain(*args, **k),
                               f"verify_records at the {what} shape, "
                               f"capacity {cap}"))
        k_ms = cuda_ms(lambda: verify_records(*args, **k), 50)
        p_ms = cuda_ms(lambda: verify_records.plain(*args, **k), 3)
        b_ms, b_by, b_bytes, _ = in_ms(verify_bound(args, k, got))
        H = min(k["n_hits"], args[6].shape[0])
        log(f"verify_records at the {what} shape ({len(calls)} launch(es) "
            f"a call, {H} hit slots, step {k.get('step', 1)}, "
            f"{args[0].dtype} table of {args[0].numel()}, win_len "
            f"{k['win_len']}, capacity {cap}, n_rec {n_rec}): bit-equal to "
            f"its plain version; {k_ms:.4f} ms (plain {p_ms:.4f} ms, bytes "
            f"floor {b_ms:.6f} ms: {b_bytes} bytes); on {card}")
        times[cap] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                      "bound_by": b_by}
    return err, times


def planted_check(m, needles, base, seed, what):
    """Plant ``needles`` at ``DENSITY`` per byte into the base documents
    replicated ``DENSITY_REPS`` times; every intact planted needle must be
    found by ``match_arrays_many``, and the first 8 MiB must equal the
    host walk."""
    length = len(needles[0])
    dens, planted = planted_docs(needles, base, seed)
    n_plant = len(planted)
    hd = m.device_corpus([row.tobytes() for row in dens])
    rd = m.match_arrays_many([hd])[0]
    found = set(zip(rd["doc"].tolist(), rd["pos"].tolist(),
                    rd["pattern"].tolist()))
    intact = [(d, o + length, p) for d, o, p in planted
              if dens[d, o : o + length].tobytes() == needles[p]]
    missing = [x for x in intact if x not in found]
    assert not missing, f"{what}: planted needles not found: {missing[:5]}"
    n_slice = (8 << 20) // DOC_BYTES
    ref = host_walk(m.automaton, dens[:n_slice])
    sel = rd["doc"] < n_slice
    got_arr = np.stack([rd["doc"][sel], rd["pos"][sel], rd["pattern"][sel]])
    assert np.array_equal(got_arr, ref), f"{what}: 8 MiB != host walk"
    assert np.array_equal(rd["start_postion"], rd["pos"] - length)
    log(f"{what}: {dens.size / 2**20:.0f} MiB, {n_plant} planted, "
        f"{len(intact)} intact all found, {rd['doc'].shape[0]} matches; "
        f"8 MiB slice equals the host walk ({ref.shape[1]} matches)")
    return hd, rd


def needle_set(length, seed=1337, n=N_NEEDLES):
    """``n`` distinct needles of ``length`` bytes over ``abcdef`` drawn
    from ``default_rng(seed)``: a stream apart from the ``random.Random``
    one that drew the base documents, so these hold only chance
    occurrences of them."""
    rng = np.random.default_rng(seed)
    pool = np.frombuffer(ALPHABET, np.uint8)
    out = set()
    while len(out) < n:
        out.add(rng.choice(pool, length).tobytes())
    return sorted(out)


def timed_passes(torch, run, passes):
    """CUDA-event ms per pass of ``passes`` calls of ``run``, the last
    call's result, and host-clock ms per pass."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    w0 = time.perf_counter()
    e0.record()
    for _ in range(passes):
        res = run()
    e1.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - w0) * 1e3 / passes
    return e0.elapsed_time(e1) / passes, res, wall


def phase_rows_path(torch, base, card, bwv, ptxas, parent=None):
    """The per-row sampled filter at the headline's 128 MiB: route, timed
    and counted batch, no host sync in its dispatch, the kernel at this
    shape against plain and bound, its parts and its profiler device time
    (beside the ``parent`` csrc's kernel, if given), planted needles."""
    from php_aho_corasick_tpu_torch import Matcher, ScanConfig
    from php_aho_corasick_tpu_torch.ops.filter_cuda import (
        _bank_probe_torch, bloom_word_vmem_launch_shape,
    )
    from php_aho_corasick_tpu_torch.ops.filter_torch import (
        sampled_gram_codes, u32,
    )

    needles = needle_set(ROWS_LEN)
    m = Matcher([{"id": i, "value": p} for i, p in enumerate(needles)],
                ScanConfig(backend="device", chunk_len=4096), device=DEVICE)
    cm = m.cascade_model
    p = cm.plan
    assert (p.q, p.stride, len(p.vmem_salts), p.vmem_pack) == (9, 5, 7, 4), \
        p.reason
    docs = [row.tobytes() for row in base] * HEADLINE_REPS
    total = sum(map(len, docs))
    assert m._pick_engine(total) == "cascade" and cm.records_ok
    h = m.device_corpus(docs)
    assert h.fused_phases(cm) is None
    B, L = h.chunks_d.shape
    log(f"rows path: plan {p.reason}, table {tuple(p.vmem_words.shape)}, "
        f"states {m.automaton.n_states}, win_len {cm.win_len}, "
        f"{total / 2**20:.0f} MiB in rows [{B}, {L}], "
        f"{B * -(-L // p.stride)} grid cells")
    warm = m.match_arrays(h)
    m.match_arrays_many([h] * BATCH)  # warm the batch structure
    fallbacks = m.stats.records_fallbacks
    bwv.launches = 0
    ms, res, wall = timed_passes(
        torch, lambda: m.match_arrays_many([h] * BATCH), 1)
    ms, wall = ms / BATCH, wall / BATCH
    launches = bwv.launches
    assert launches >= BATCH, f"bloom_word_vmem launched {launches} times"
    assert m.stats.records_fallbacks == fallbacks, "batch fell back"
    for r in res:
        for key in r:
            assert np.array_equal(r[key], warm[key]), key
    log(f"rows path: match_arrays_many([handle] * {BATCH}) over "
        f"{total / 2**20:.0f} MiB: {ms:.3f} ms/pass by CUDA events "
        f"({wall:.3f} ms wall), {total / ms / 1e6:.2f} GB/s, "
        f"{res[0]['doc'].shape[0]} matches/pass, bloom_word_vmem launches "
        f"{launches}, on {card}")
    trace_breakdown(torch, lambda n: m.match_arrays_many([h] * n), card)
    pending = assert_no_sync(
        torch, lambda: m._records_batch_dispatch([h] * 2, cm))
    m._records_batch_finish(*pending, True)
    log("sync check (set_sync_debug_mode='error'): no host sync in the rows "
        "dispatch")

    # the kernel on the plan's table at this shape, against plain and bound
    dev = cm.device_arrays
    codes = sampled_gram_codes(h.chunks_d, p.q, p.stride)
    table = dev["vmem_table"]
    kargs = (p.vmem_salts, p.vmem_log2_rows, p.vmem_pack)
    got = bwv(table, codes, *kargs)
    want = _bank_probe_torch(table, u32(codes), *kargs)
    torch.cuda.synchronize()
    err = compare([got], [want], "bloom_word_vmem, rows plan, 128 MiB")
    k_ms = cuda_ms(lambda: bwv(table, codes, *kargs), 50)
    p_ms = cuda_ms(lambda: _bank_probe_torch(table, u32(codes), *kargs), 3)
    b_ms, b_by, b_bytes, b_ops = in_ms(bound_of(
        codes.numel() * 8 + table.numel() * 4,
        12 * salt_probes(table, u32(codes), *kargs)))
    f_ms = cuda_ms(lambda: cm.scan_hits_sampled(
        h.chunks_d, h.lengths_d, max(cm._cap_hits, 256)), 5)
    log(f"bloom_word_vmem at {tuple(codes.shape)} codes: {k_ms:.4f} ms "
        f"({100 * b_ms / k_ms:.1f}% of bound; plain {p_ms:.3f} ms, bound "
        f"{b_ms:.4f} ms by {b_by}: {b_bytes} bytes, {b_ops} ops), "
        f"{int((got != 0).sum())} coarse hits; the whole per-row filter "
        f"{f_ms:.3f} ms; on {card}")
    # its parts: a table of zeros (the streaming and the unconditional
    # first probes), of ones (every code takes all k probes), the plan's
    # table; and a device copy of the same bytes (codes read, as many
    # words written) as the streaming's yardstick
    zeros, ones = torch.zeros_like(table), torch.full_like(table, -1)
    z_ms = cuda_ms(lambda: bwv(zeros, codes, *kargs), 50)
    o_ms = cuda_ms(lambda: bwv(ones, codes, *kargs), 50)
    copy_to = torch.empty_like(codes)
    c_ms = cuda_ms(lambda: copy_to.copy_(codes), 50)
    log(f"bloom_word_vmem parts: {z_ms:.4f} ms with a zero table, "
        f"{o_ms:.4f} ms with a table of ones (all {len(p.vmem_salts)} "
        f"probes a code), {k_ms:.4f} ms with the plan's table; a copy of "
        f"the codes {c_ms:.4f} ms; on {card}")
    shape = bloom_word_vmem_launch_shape(table.numel(), p.vmem_pack,
                                         codes.numel())
    log(f"bloom_word_vmem launch: {shape}, {4 * table.numel()} bytes of "
        f"tables; {ptxas}")
    # one yardstick for this design and, with --parent, another checkout's:
    # the profiler's device time, in turns on this card
    runs = [("this tree", lambda: bwv(table, codes, *kargs))]
    if parent is not None:
        prun = parent_bloom_word_vmem(parent)
        pgot = prun(table, codes, *kargs)
        torch.cuda.synchronize()
        compare([pgot], [want], "parent bloom_word_vmem, rows plan")
        runs = [("parent", lambda: prun(table, codes, *kargs)), runs[0]]
        runs = runs + runs[::-1]
    prof = [(who, profiler_ms(torch, fn, 20, "bloom_word_vmem"))
            for who, fn in runs]
    log("bloom_word_vmem by the profiler's device time, ms a launch: "
        + ", ".join(f"{who} {t:.4f}" if t is not None else
                    f"{who} not measured" for who, t in prof)
        + f"; on {card}")
    planted_check(m, needles, base, int(DENSITY * 1e9) + 1,
                  "rows planted corpus")
    return {
        "name": "bloom_word_vmem",
        "route": "cuda",
        "source": "php_aho_corasick_tpu_torch/csrc/bloom_word_vmem.cu",
        "replaces": "php_aho_corasick_tpu/ops/filter_pallas.py:223",
        "launches": launches,
        "max_abs_err": err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    }


def phase_anchored_path(torch, base, card, bh):
    """The anchored cascade at 32 MiB (its filter probes through the
    ``bloom_hit`` kernel): timed, counted, split into device filter /
    fetch / host verify, and held against the dense engine and the host
    walk; then the kernel against ``bloom_hit_take`` at this shape."""
    from php_aho_corasick_tpu_torch import Matcher, ScanConfig
    from php_aho_corasick_tpu_torch.models.cascade import _next_cap
    from php_aho_corasick_tpu_torch.ops.filter_torch import (
        bloom_hit_take, bloom_slots, gram_codes,
    )
    from php_aho_corasick_tpu_torch.ops.scan_torch import _classes

    needles = needle_set(ANCHORED_LEN)
    specs = [{"id": i, "value": p} for i, p in enumerate(needles)]
    docs = [row.tobytes() for row in base] * ANCHORED_REPS
    total = sum(map(len, docs))
    m = Matcher(specs, ScanConfig(backend="device", engine="cascade",
                                  chunk_len=4096), device=DEVICE)
    cm = m.cascade_model
    p = cm.plan
    assert p.mode == "anchored" and (p.q, p.offsets, p.log2_bits) == (
        7, (0,), 17), p.reason
    h = m.device_corpus(docs)
    B, L = h.chunks_d.shape
    log(f"anchored path: plan q={p.q} offsets {p.offsets} 2^{p.log2_bits}"
        f"-bit bloom, states {m.automaton.n_states}, "
        f"{total / 2**20:.0f} MiB in rows [{B}, {L}]")
    warm = m.match_arrays(h)
    bh.launches = 0
    ms, got, wall = timed_passes(torch, lambda: m.match_arrays(h),
                                 ANCHORED_PASSES)
    launches = bh.launches
    assert launches >= ANCHORED_PASSES, f"bloom_hit launched {launches}"
    for key in got:
        assert np.array_equal(got[key], warm[key]), key
    # one pass in parts: the filter at the configured capacity, again at
    # the observed count (the reference's ladder), fetch, verify
    cap = m.config.match_capacity

    def filt(capacity):
        return cm.scan_candidates(h.chunks_d, h.lengths_d, capacity)

    n = int(filt(cap)[1])
    cap2 = _next_cap(n)
    f1 = cuda_ms(lambda: filt(cap), 3)
    f2 = cuda_ms(lambda: filt(cap2), 3)
    idx, _ = filt(cap2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx_np = idx[:n].cpu().numpy()
    fetch = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    cm.verify_arrays(h.packed, idx_np, n)
    verify = (time.perf_counter() - t0) * 1e3
    log(f"anchored path: match_arrays(handle) x {ANCHORED_PASSES}: "
        f"{ms:.3f} ms/pass by CUDA events ({wall:.3f} ms wall), "
        f"{total / ms / 1e6:.3f} GB/s, {got['doc'].shape[0]} matches/pass, "
        f"{n} candidates, bloom_hit launches {launches}; parts: filter "
        f"{f1:.3f} ms at capacity {cap} + {f2:.3f} ms at {cap2} (device), "
        f"fetch {fetch:.3f} ms, host verify {verify:.3f} ms (host clock); "
        f"on {card}")

    # the dense engine on all 32 MiB, the host walk on 8 MiB
    md = Matcher(specs, ScanConfig(backend="device", engine="dfa",
                                   chunk_len=4096,
                                   match_capacity=TILE_CAPACITY),
                 device=DEVICE)
    rd = md.match_arrays(h)
    for key in got:
        assert np.array_equal(rd[key], got[key]), f"dfa differs: {key}"
    n_slice = min((8 << 20) // DOC_BYTES, len(docs))
    ref = host_walk(md.automaton, np.frombuffer(b"".join(docs[:n_slice]),
                                                np.uint8)
                    .reshape(n_slice, DOC_BYTES))
    sel = got["doc"] < n_slice
    assert np.array_equal(np.stack([got["doc"][sel], got["pos"][sel],
                                    got["pattern"][sel]]), ref), \
        "anchored: 8 MiB slice != host walk"
    log(f"anchored records: equal to the dense engine "
        f"on {total / 2**20:.0f} MiB and the host walk on 8 MiB "
        f"({ref.shape[1]} matches)")

    # the kernel on the plan's bloom at this shape, against plain and bound
    dev = cm.device_arrays
    cls = _classes(h.chunks_d, dev["byte_class"], dev["used_bytes"])
    slots = bloom_slots(gram_codes(cls, p.q, m.automaton.n_classes),
                        p.log2_bits, p.salts[0])
    words = dev["bloom_words"][0]
    hit = bh(words, slots)
    want = bloom_hit_take(words, slots)
    torch.cuda.synchronize()
    err = compare([hit], [want], "bloom_hit, anchored plan, 32 MiB")
    k_ms = cuda_ms(lambda: bh(words, slots), 50)
    p_ms = cuda_ms(lambda: bloom_hit_take(words, slots), 10)
    b_ms, b_by, b_bytes, b_ops = in_ms(hit_bound(words, slots))
    log(f"bloom_hit at {tuple(slots.shape)} slots: {k_ms:.4f} ms (plain "
        f"bloom_hit_take {p_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by}: "
        f"{b_bytes} bytes, {b_ops} ops), {int(hit.sum())} set bits; on "
        f"{card}")
    return {
        "name": "bloom_hit",
        "route": "cuda",
        "source": "php_aho_corasick_tpu_torch/csrc/bloom_hit.cu",
        "replaces": "php_aho_corasick_tpu/ops/filter_pallas.py:838",
        "launches": launches,
        "max_abs_err": err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        # the plain version is the library path: one take of the words
        # and two shifts, no kernel of this package
        "library_ms": p_ms,
    }


@contextlib.contextmanager
def on_plain(*names):
    """The hand kernels ``names`` run their plain versions on the card's
    tensors while the context is open (their entries' launch code swapped
    for the plain version)."""
    from php_aho_corasick_tpu_torch.ops._build import KERNELS

    def plain(kernel, *args, **kw):
        return kernel.plain(*args, **kw)

    saved = [(KERNELS[name], KERNELS[name].code) for name in names]
    for kernel, _ in saved:
        kernel.code = plain
    try:
        yield
    finally:
        for kernel, code in saved:
            kernel.code = code


def device_ops(torch, run):
    """Device operations (kernels, copies, fills) and their summed device
    ms in one call of ``run``, by ``torch.profiler`` after a warm call."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    n, busy = 0, 0.0
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            t = getattr(e, "self_device_time_total", None)
            busy += (t if t is not None
                     else getattr(e, "self_cuda_time_total", 0)) / 1e3
            n += e.count
    return n, busy


def bound_args(name, args, kw):
    """A wrapper call's arguments by parameter name."""
    from php_aho_corasick_tpu_torch.ops._build import KERNELS

    b = inspect.signature(KERNELS[name]).bind(*args, **kw)
    b.apply_defaults()
    return b.arguments


def extract_bound(args, kw, out):
    """``bound_of`` the grouped filter's grid stage on these inputs: the
    corpus words and short words read once, one 4-byte bloom word a probe
    (one a cell under the first salt where ``min_long_len`` is on, then
    each extracted slot's re-probes: one a further salt, or one of the
    second family), the slot arrays and counts written once; ``4
    ceil(q/4) + 6`` operations a cell for the code (dp4a and joins) and ~6
    a probe (xor, multiply, shift, load, AND, test).  Also returns the
    bytes that the probes' 32-byte sectors would add."""
    a = bound_args("grouped_take_extract", args, kw)
    wc, sw, spc = a["wc"], a["sw"], a["spc"]
    n_grid = wc.shape[0] * (wc.shape[1] // spc)
    long_on = int(a["mll"].reshape(-1)[0]) > 0
    slots = int((out[0] >= 0).sum())
    again = 1 if a["words2"] is not None else len(a["salts"]) - 1
    probes = (n_grid + slots * again) if long_on else 0
    n_bytes = (wc.numel() * 4 + (sw.numel() * 4 if sw is not None else 0)
               + 4 + 4 * probes + sum(t.numel() * 4 for t in out))
    ops = n_grid * (4 * ((a["q"] - 1) // 4 + 1) + 6) + 6 * probes
    return bound_of(n_bytes, ops), 28 * probes


def refine_bound(args, kw, out):
    """``bound_of`` the grouped filter's refinement on these inputs: each
    entry's slot number read and its three words written, three slot
    words gathered a live entry, and for each single-alignment long word
    its window's corpus words (``ceil(l16 / 4) + 1``) and one prefix-bloom
    word a salt; ~12 operations an entry, ~3 a window byte and ~6 a salt.
    Also returns the bytes that the gathers' 32-byte sectors would add."""
    a = bound_args("grouped_take_refine", args, kw)
    slot = a["slot"]
    valid = slot < 2**31 - 1
    live = int(valid.sum())
    lw = a["w_s"].reshape(-1)[slot[valid].long()].long() & 0xFFFFFFFF
    stride = 4 * a["spc"]
    v = lw & ((1 << stride) - 1)
    single = int(((v != 0) & ((v & (v - 1)) == 0)).sum()) if (
        a["prefix_words"] is not None) else 0
    l16, k = a["prefix_len"], len(a["prefix_salts"])
    words = (l16 + 3) // 4 + 1
    n_bytes = slot.numel() * 16 + live * 12 + single * 4 * (words + k)
    ops = slot.numel() * 12 + single * (3 * l16 + 6 * k)
    return bound_of(n_bytes, ops), 28 * (3 * live + single * k) + 32 * single


def grouped_check(torch, card, what, run):
    """The grouped take filter of one cell (``run()``: one filter call on
    its handle): every launch of both kernels in that call held against
    its plain version on the same inputs; each kernel's ms at the call's
    shapes beside its plain version's and its bound; then the filter's
    device ms a call (CUDA events, host queued ahead) on the kernels and
    on their plain versions in turns (plain, kernels, kernels, plain), and
    its device operations and their busy ms a call by the profiler.
    Returns each kernel's times."""
    from php_aho_corasick_tpu_torch.ops._build import KERNELS

    bounds = {"grouped_take_extract": extract_bound,
              "grouped_take_refine": refine_bound}
    _, calls = held_calls(run, *bounds)
    times = {}
    for name, bound in bounds.items():
        args, kw, out = calls[name][0]
        kernel = KERNELS[name]
        k_ms = cuda_ms(lambda: kernel(*args, **kw), 50)
        p_ms = cuda_ms(lambda: kernel.plain(*args, **kw), 5)
        b, sectors = bound(args, kw, out)
        b_ms, b_by, b_bytes, b_ops = in_ms(b)
        shapes = [tuple(t.shape) for t in args if hasattr(t, "shape")]
        log(f"{name} at the {what} shape ({len(calls[name])} call(s) a "
            f"filter call, inputs {shapes}): bit-equal to its plain "
            f"version; {k_ms:.4f} ms (plain {p_ms:.4f} ms, bound "
            f"{b_ms:.6f} ms by {b_by}: {b_bytes} bytes, {b_ops} ops; the "
            f"random gathers' 32-byte sectors add {sectors} bytes, "
            f"{in_ms(bound_of(sectors, 0))[0]:.6f} ms); on {card}")
        times[name] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                       "bound_by": b_by}
    turns = []
    for who in ("plain", "kernels", "kernels", "plain"):
        with (on_plain(*bounds) if who == "plain"
              else contextlib.nullcontext()):
            turns.append(f"{who} {cuda_ms(run, 5):.3f}")
    n_k, busy_k = device_ops(torch, run)
    with on_plain(*bounds):
        n_p, busy_p = device_ops(torch, run)
    log(f"grouped take filter at the {what} shape, device ms a call in "
        f"turns: {', '.join(turns)}; device operations a call: kernels "
        f"{n_k} ({busy_k:.3f} ms busy), plain {n_p} ({busy_p:.3f} ms "
        f"busy); on {card}")
    return times


def flat_times(torch, card, what, call):
    """The flat take filter's kernel on one captured call's inputs: its
    device ms beside its plain version's and the least time of the work
    (``portbench.bounds.sampled_filter_work``: the corpus once, 4 bytes
    and 6 operations a probe; the metric ``take_filter_roofline_pct``'s
    floor), and what the probes' 32-byte sectors would add to it."""
    from php_aho_corasick_tpu_torch.ops.filter_cuda import flat_take_extract
    from portbench.bounds import sampled_filter_work

    name = "flat_take_extract"
    args, kw, out = call
    a = bound_args(name, args, kw)
    k_ms = cuda_ms(lambda: flat_take_extract(*args, **kw), 20)
    p_ms = cuda_ms(lambda: flat_take_extract.plain(*args, **kw), 3)
    rows, row_len = a["chunks"].shape
    b = sampled_filter_work(rows, row_len, a["q"], a["stride"],
                            a["words"].numel() * 4, 6)
    sectors = 28 * rows * -(-row_len // a["stride"])
    log(f"{name} at the {what} shape (chunks {tuple(a['chunks'].shape)}, "
        f"q {a['q']}, stride {a['stride']}, {len(a['salts'])} salt(s), "
        f"2^{a['log2_words']}-word bloom, capacity {a['capacity']}, "
        f"{int(out[3])} hits): bit-equal to its plain version; "
        f"{k_ms:.4f} ms (plain {p_ms:.4f} ms, bound "
        f"{b['seconds'] * 1e3:.6f} ms by {b['by']}: {b['bytes']} bytes, "
        f"{b['ops']} ops, {100 * b['seconds'] * 1e3 / k_ms:.2f}% of it; the "
        f"first probes' 32-byte sectors add {sectors} bytes, "
        f"{in_ms(bound_of(sectors, 0))[0]:.6f} ms); on {card}")
    return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b["seconds"] * 1e3,
            "bound_by": b["by"]}


def flat_check(torch, card, what, run):
    """The flat take filter of one cell (``run()``: one filter call on its
    handle): its one launch held against its plain version, then
    :func:`flat_times`.  Returns the times."""
    name = "flat_take_extract"
    _, calls = held_calls(run, name)
    assert len(calls[name]) == 1, f"{what}: {len(calls[name])} launches"
    return flat_times(torch, card, what, calls[name][0])


def flat_genome_check(torch, card):
    """The flat take filter's kernel at one chromosome of the genome cell:
    ``GENOME_ROWS`` rows of ``GENOME_ROW_LEN`` random ACGT bytes, its plan
    (q 15, stride 6, one salt, a ``2**GENOME_LOG2_WORDS``-word bloom, a
    capacity of 2^18), the bloom's words live at ``GENOME_LIVE``: one launch, held against its
    plain version and timed (:func:`flat_times`)."""
    from php_aho_corasick_tpu_torch.ops.filter_cuda import flat_take_extract
    from php_aho_corasick_tpu_torch.ops.filter_torch import to_i32

    g = torch.Generator(device=DEVICE).manual_seed(20)
    pool = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device=DEVICE)
    chunks = pool[torch.randint(0, 4, (GENOME_ROWS, GENOME_ROW_LEN),
                                generator=g, device=DEVICE)]
    n = 1 << GENOME_LOG2_WORDS
    bits = torch.randint(1, 1 << 6, (n,), generator=g, device=DEVICE)
    live = torch.rand(n, generator=g, device=DEVICE) < GENOME_LIVE
    words = to_i32(torch.where(live, bits, 0))
    del bits, live
    mll = torch.tensor(20, dtype=torch.int32, device=DEVICE)
    kw = dict(q=15, stride=6, log2_words=GENOME_LOG2_WORDS,
              salts=(0x85EBCA6B,), capacity=1 << 18)
    before = flat_take_extract.launches
    out, calls = held_calls(
        lambda: flat_take_extract(words, chunks, None, mll, **kw),
        "flat_take_extract")
    assert flat_take_extract.launches == before + 1
    call, = calls["flat_take_extract"]
    assert 0 < int(out[3]) <= kw["capacity"], int(out[3])
    return flat_times(torch, card, "genome chromosome", call)


def phase_take_path(torch, base, card, head):
    """The sampled take filters: take-flat at 16,384 needles (the flat
    take filter's kernel; the records verify on its int32 dense table),
    take-grouped on the headline's handle (the grouped filter's two
    kernels and the records verify on the int16 dense table), force-take;
    the flat kernel at a genome chromosome's shape.  ``head`` is the
    headline's ``(needles, handle, warm result)``.  Returns the hand
    kernels' launches of both timed batches, the grouped kernels' times
    at its shapes (:func:`grouped_check`), the records verify's largest
    difference and times by shape (:func:`verify_check`), and the flat
    kernel's times by shape (:func:`flat_check`)."""
    from php_aho_corasick_tpu_torch import Matcher, ScanConfig

    docs = [row.tobytes() for row in base] * HEADLINE_REPS
    total = sum(map(len, docs))

    def no_host_verify(*args, **kw):
        raise AssertionError("the records path reached host verify_arrays")

    # take-flat: the default config builds no bank bloom for this set
    needles = needle_set(NEEDLE_LEN, n=TAKE_NEEDLES)
    t0 = time.perf_counter()
    m = Matcher([{"id": i, "value": p} for i, p in enumerate(needles)],
                ScanConfig(backend="device", chunk_len=4096), device=DEVICE)
    m.finalize()
    cm = m.cascade_model
    build_s = time.perf_counter() - t0
    p = cm.plan
    assert (p.q, p.stride, p.log2_words, p.vmem_words,
            m.automaton.n_states) == (10, 7, 27, None, 185537), p.reason
    assert cm.bloom_impl() == "take" and cm.records_ok, cm.win_len
    assert m._pick_engine(total) == "cascade"
    t0 = time.perf_counter()
    h = m.device_corpus(docs)
    torch.cuda.synchronize()
    up_s = time.perf_counter() - t0
    B, L = h.chunks_d.shape
    assert cm.take_branch(L) == "flat"
    assert h.fused_phases(cm) is None
    log(f"take-flat: {len(needles)} needles, plan {p.reason}, 2^"
        f"{p.log2_words}-word positional bloom ({4 << p.log2_words} bytes "
        f"on the card), no bank bloom, states {m.automaton.n_states}, "
        f"win_len {cm.win_len}; build {build_s:.2f} s; {total / 2**20:.0f} "
        f"MiB in rows [{B}, {L}], {B * -(-L // p.stride)} grid cells, "
        f"upload {up_s:.2f} s")
    cm.verify_arrays = no_host_verify
    warm = m.match_arrays(h)
    m.match_arrays_many([h] * BATCH)  # warm the batch structure
    fallbacks = m.stats.records_fallbacks
    before = launch_counts()
    ms, res, wall = timed_passes(
        torch, lambda: m.match_arrays_many([h] * BATCH), 1)
    ms, wall = ms / BATCH, wall / BATCH
    flat_launched = launch_counts(before)
    assert m.stats.records_fallbacks == fallbacks, "batch fell back"
    launched_only(flat_launched, "take-flat", BATCH, "flat_take_extract",
                  "verify_records")
    # the flat kernel once a chain, as the records verify
    assert (flat_launched["flat_take_extract"]
            == flat_launched["verify_records"]), flat_launched
    assert not cm._force_take and cm.take_branch(L) == "flat"
    for r in res:
        for key in r:
            assert np.array_equal(r[key], warm[key]), key
    f_ms = cuda_ms(lambda: cm.scan_hits_sampled(
        h.chunks_d, h.lengths_d, max(cm._cap_hits, 256)), 5)
    c_ms = cuda_ms(lambda: cm.launch_device_records(
        h.chunks_d, h.lengths_d, h.emit_from_d, max(cm._cap_hits, 256),
        max(cm._cap_flagged, 256)), 5)
    log(f"take-flat: match_arrays_many([handle] * {BATCH}) over "
        f"{total / 2**20:.0f} MiB: {ms:.3f} ms/pass by CUDA events "
        f"({wall:.3f} ms wall), {total / ms / 1e6:.2f} GB/s, "
        f"{res[0]['doc'].shape[0]} matches/pass, hand kernel launches "
        f"{flat_launched}, no records fallback, no host "
        f"verify; device time of the flat "
        f"filter {f_ms:.3f} ms, of filter + record verify {c_ms:.3f} ms "
        f"(capacity {max(cm._cap_hits, 256)}); on {card}")
    flat = {"take-flat": flat_check(
        torch, card, "take-flat", lambda: cm.scan_hits_sampled(
            h.chunks_d, h.lengths_d, max(cm._cap_hits, 256)))}
    # one pass's host half: the fetch of the records and their expansion
    rc, rp, _, nr_d, _ = cm.launch_device_records(
        h.chunks_d, h.lengths_d, h.emit_from_d, max(cm._cap_hits, 256),
        max(cm._cap_flagged, 256))
    nr = int(nr_d)
    t0 = time.perf_counter()
    rc_np, rp_np = rc[:nr].cpu().numpy(), rp[:nr].cpu().numpy()
    t1 = time.perf_counter()
    cm.emit_records_arrays(h.packed, rc_np, rp_np, nr)
    t2 = time.perf_counter()
    log(f"take-flat pass parts: fetch of {nr} records {(t1 - t0) * 1e3:.3f} "
        f"ms, host expansion {(t2 - t1) * 1e3:.3f} ms (host clock); on "
        f"{card}")
    trace_breakdown(torch, lambda n: m.match_arrays_many([h] * n), card)
    vr_shapes = {"take-flat": verify_check(torch, card, "take-flat",
                                           lambda: m.match_arrays(h))}
    pending = assert_no_sync(
        torch, lambda: m._records_batch_dispatch([h] * 2, cm))
    m._records_batch_finish(*pending, True)
    log("sync check (set_sync_debug_mode='error'): no host sync in the "
        "take-flat dispatch")
    planted_check(m, needles, base, int(DENSITY * 1e9) + 2,
                  "take-flat planted corpus")
    del m, cm, h

    # take-grouped: the headline set asks for the take filter
    needles_h, hh, warm_h = head
    mg = Matcher([{"id": i, "value": v} for i, v in enumerate(needles_h)],
                 ScanConfig(backend="device", chunk_len=4096,
                            bloom_impl="take"), device=DEVICE)
    cg = mg.cascade_model
    L = hh.chunks_d.shape[1]
    assert cg.bloom_impl() == "take" and cg.take_branch(L) == "grouped"
    assert cg.plan.prefix_words is not None and cg.records_ok
    cg.verify_arrays = no_host_verify
    warm = mg.match_arrays(hh)
    for key in warm:
        assert np.array_equal(warm[key], warm_h[key]), f"grouped: {key}"
    mg.match_arrays_many([hh] * BATCH)
    fallbacks = mg.stats.records_fallbacks
    before = launch_counts()
    ms, res, wall = timed_passes(
        torch, lambda: mg.match_arrays_many([hh] * BATCH), 1)
    ms, wall = ms / BATCH, wall / BATCH
    launched = launch_counts(before)
    launched_only(launched, "take-grouped", BATCH, "grouped_take_extract",
                  "grouped_take_refine", "verify_records")
    assert mg.stats.records_fallbacks == fallbacks, "batch fell back"
    assert cg.take_branch(L) == "grouped"
    for r in res:
        for key in r:
            assert np.array_equal(r[key], warm_h[key]), key
    cap = max(cg._cap_hits, 256)
    f_ms = cuda_ms(lambda: cg.scan_hits_sampled(
        hh.chunks_d, hh.lengths_d, cap), 5)
    log(f"take-grouped: match_arrays_many([headline handle] * {BATCH}) "
        f"with bloom_impl='take': {ms:.3f} ms/pass by CUDA events "
        f"({wall:.3f} ms wall), {res[0]['doc'].shape[0]} matches/pass "
        f"(equal to the fused route), hand kernel launches "
        f"{launched}, group size {cg.take_group_block_r()}, slot capacity "
        f"{cg._cap_coarse}; device time of the grouped filter {f_ms:.3f} "
        f"ms; on {card}")
    trace_breakdown(torch, lambda n: mg.match_arrays_many([hh] * n), card)
    pending = assert_no_sync(
        torch, lambda: mg._records_batch_dispatch([hh] * 2, cg))
    mg._records_batch_finish(*pending, True)
    log("sync check (set_sync_debug_mode='error'): no host sync in the "
        "take-grouped dispatch")
    # both kernels at the shapes this path gives them, against their plain
    # versions; the filter a call on the kernels and on the plain versions
    times = grouped_check(
        torch, card, "take-grouped",
        lambda: cg.scan_hits_sampled(hh.chunks_d, hh.lengths_d, cap))
    vr_shapes["take-grouped"] = verify_check(
        torch, card, "take-grouped", lambda: mg.match_arrays(hh))
    planted_check(mg, needles_h, base, int(DENSITY * 1e9),
                  "take-grouped planted corpus")
    del mg, cg

    # force-take: > 128 survivors in every extraction group
    text = FORCE_TAKE_NEEDLE * FORCE_TAKE_REPS
    mf = Matcher([{"id": 0, "value": FORCE_TAKE_NEEDLE}],
                 ScanConfig(backend="device", engine="cascade",
                            cascade_mode="sampled", bloom_impl="pallas_vmem",
                            chunk_len=4096), device=DEVICE)
    cf = mf.cascade_model
    assert cf.bloom_impl() == "pallas_vmem"
    t0 = time.perf_counter()
    recs = mf.match(text)
    first_s = time.perf_counter() - t0
    assert cf._force_take and cf.bloom_impl() == "take"
    assert cf.take_branch(4096) == "flat"
    assert len(recs) == FORCE_TAKE_REPS, len(recs)
    assert recs[0]["pos"] == len(FORCE_TAKE_NEEDLE)
    assert recs[-1]["pos"] == len(text)
    ms, again, wall = timed_passes(torch, lambda: mf.match(text), 1)
    assert again == recs, "force-take: a second call differs"
    log(f"force-take: {len(text)} bytes, {len(recs)} records (first pos "
        f"{recs[0]['pos']}, last {recs[-1]['pos']}); switched to the flat "
        f"take filter in the first call ({first_s:.3f} s, host clock); a "
        f"second call on the same matcher equal, {ms:.3f} ms by CUDA events "
        f"({wall:.3f} ms wall); on {card}")
    del mf, cf
    launched = {k: n + flat_launched[k] for k, n in launched.items()}
    flat["genome chromosome"] = flat_genome_check(torch, card)
    return launched, times, vr_shapes, flat


def tile_args(torch, rng, S, U, B, L, dtype, with_lengths):
    """A random DFA of ``S`` states over ``U`` used bytes and ``[B, L]``
    rows (a third of them empty, a quarter full), as the tile kernel's
    CUDA arguments."""
    C = U + 1
    used = np.sort(rng.choice(256, U, replace=False)).astype(np.uint8)
    byte_class = np.zeros(256, np.int32)
    byte_class[used] = np.arange(1, U + 1)
    pool = np.concatenate([used, rng.integers(0, 256, 3)])
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[::3] = 0
    lengths[1::4] = L
    c = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(DEVICE)  # noqa: E731
    args = (c(rng.integers(0, S, S * C).astype(dtype)), c(byte_class),
            c(used), c(rng.choice(pool, (B, L)).astype(np.uint8)),
            c(rng.integers(0, S, B).astype(np.int32)), C)
    return args, c(lengths) if with_lengths else None


def phase_tile_random(torch, sst):
    """The tile kernel against its plain version on random tables."""
    rng = np.random.default_rng(1)
    err = 0
    cases = [
        (512, 7, 300, 1000, np.int32, True),  # S*C = 4096, L % 64 != 0
        (1024, 3, 1000, 2048, np.int16, True),  # S*C = 4096, int16
        (90, 40, 129, 77, np.int16, True),  # > 32 used bytes, L % 16 != 0
        (31, 2, 5, 64, np.int32, False),  # no lengths: carry = last column
        (20, 3, 7, 0, np.int16, True),  # no bytes: carry = init
    ]
    for S, U, B, L, dtype, with_len in cases:
        args, lt = tile_args(torch, rng, S, U, B, L, dtype, with_len)
        got = sst(*args, lengths=lt)
        want = sst.plain(*args, lt)
        torch.cuda.synchronize()
        err = max(err, compare(got, want, f"tile S={S} C={U + 1} [{B}, {L}] "
                                          f"{np.dtype(dtype).name}"))
    return len(cases), err


def ac_tables(torch, pats):
    """The tile kernel's table arguments for the port's Aho-Corasick DFA
    of ``pats`` (built on the host), and the automaton."""
    from php_aho_corasick_tpu_torch import Matcher, ScanConfig

    auto = Matcher([{"value": p} for p in pats], ScanConfig(backend="device"),
                   device="cpu").automaton
    c = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(DEVICE)  # noqa: E731
    return (c(auto.table.reshape(-1).astype(np.int32)),
            c(auto.byte_class.astype(np.int32)), c(auto.used_bytes)), auto


def phase_tile_sync(torch, sst):
    """The segmented walk (``sync_len`` = longest pattern) against the
    plain walk on Aho-Corasick tables: the probe set, a set at S*C near
    4096 with a 380-byte pattern, nonzero initial states, ragged and empty
    rows, L not a multiple of 16, the longest pattern planted across the
    segment boundaries; returns ``(cases, max_abs_err)``."""
    from php_aho_corasick_tpu_torch.ops.scan_cuda import tile_segment_plan

    r6 = np.random.default_rng(6)
    letters = np.frombuffer(ALPHABET, np.uint8)
    near = {r6.choice(letters, r6.integers(1, 9)).tobytes()
            for _ in range(60)}
    near.add(r6.choice(letters, 380).tobytes())
    sets = {"probe": probe_set(), "near-4096": sorted(near)}
    cases = [("probe", 4096, 2176), ("probe", 999, 1000),
             ("near-4096", 512, 4000), ("near-4096", 300, 2008),
             ("probe", 7, 0)]
    rng = np.random.default_rng(7)
    c = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(DEVICE)  # noqa: E731
    err = 0
    for name, B, L in cases:
        pats = sets[name]
        tabs, auto = ac_tables(torch, pats)
        assert auto.n_states * auto.n_classes <= 4096
        longest = max(pats, key=len)
        seg_len, n_seg, _ = tile_segment_plan(L, auto.max_len)
        chunks = rng.choice(np.concatenate([letters, [0x20]]), (B, L))
        chunks = chunks.astype(np.uint8)
        for k in range(1, n_seg):
            o = k * seg_len - len(longest) + 2
            if 0 <= o <= L - len(longest):
                chunks[::2, o : o + len(longest)] = np.frombuffer(longest,
                                                                  np.uint8)
        lengths = rng.integers(0, L + 1, B).astype(np.int32)
        lengths[::5] = 0
        lengths[1::3] = L
        args = (*tabs, c(chunks),
                c(rng.integers(0, auto.n_states, B).astype(np.int32)),
                auto.n_classes)
        got = sst(*args, lengths=c(lengths), sync_len=auto.max_len)
        want = sst.plain(*args, c(lengths))
        torch.cuda.synchronize()
        err = max(err, compare(got, want, (
            f"tile sync_len={auto.max_len} {name} S*C="
            f"{auto.n_states * auto.n_classes} [{B}, {L}] {n_seg} "
            f"segments a row")))
    return len(cases), err


def ptxas_lines(report, name):
    """The compiler's register, spill and shared-memory lines of every
    instantiation of kernel ``name``, counted."""
    lines = {}
    for ln in report[name]["log"].splitlines():
        ln = ln.replace("ptxas info    :", "").strip()
        if ln.startswith("Used") or "spill" in ln:
            lines[ln] = lines.get(ln, 0) + 1
    return "; ".join(f"{n}x {ln}" for ln, n in sorted(lines.items()))


def tile_bound(table, chunks, n_classes):
    """Least time for the tile scan of ``chunks``: the bytes read and the
    int32 states written once (plus table, class map, init, lengths and
    carry), against 3 operations per byte (class lookup, multiply-add,
    table load) over the int32 rate."""
    B, L = chunks.shape
    n_bytes = B * L * (1 + 4) + B * 4 * 3 + table.numel() * 4 + 256 * 4
    return bound_of(n_bytes, 3 * B * L)


def probe_set():
    """``benchmarks/probe_tile_tpu.py``'s automaton: 40 draws of 4-8 bytes
    over ``a-f`` from ``default_rng(3)`` (sorted: a set's order varies
    from run to run)."""
    rng = np.random.default_rng(3)
    return sorted({
        bytes(rng.integers(97, 103, rng.integers(4, 9)).astype(np.uint8))
        for _ in range(40)
    })


#: the reference's tests/test1.phpt patterns and expected records
TEST1_PATTERNS = [
    {"key": "ab", "value": "alfa"},
    {"key": "ac", "value": "beta"},
    {"key": "ad", "value": "gamma", "aux": [1]},
    {"key": "ae", "value": "delta"},
    {"id": 0, "value": "zeta"},
    {"key": "ag", "value": "omega"},
    {"value": "lfa"},
]
TEST1_EXPECT = [
    {"pos": 14, "key": "ad", "aux": [1], "start_postion": 9, "value": "gamma"},
    {"pos": 19, "keyIdx": 0, "start_postion": 15, "value": "zeta"},
    {"pos": 24, "key": "ag", "start_postion": 19, "value": "omega"},
    {"pos": 28, "key": "ab", "start_postion": 24, "value": "alfa"},
    {"pos": 28, "start_postion": 25, "value": "lfa"},
]


def phase_tile_path(torch, base, card, sst, ptxas):
    """The tile path at 32 MiB: route, timed passes, kernel against its
    bound, where the pass time goes, and the records against the host
    walk, the dense engine, the default capacity and ``match_many``."""
    from php_aho_corasick_tpu_torch import (
        Matcher, ScanConfig, ahocorasick_init, ahocorasick_match,
    )
    from php_aho_corasick_tpu_torch.ops.matches import expand_matches_arrays
    from php_aho_corasick_tpu_torch.ops.scan_cuda import tile_launch_shape
    from php_aho_corasick_tpu_torch.ops.scan_torch import compact_final_states

    pats = probe_set()
    specs = [{"id": i, "value": p} for i, p in enumerate(pats)]
    m = Matcher(specs, ScanConfig(backend="device",
                                  match_capacity=TILE_CAPACITY),
                device=DEVICE)
    auto = m.automaton
    docs = [row.tobytes() for row in base] * TILE_REPS
    total = sum(map(len, docs))
    engine = m._pick_engine(total)
    assert engine == "tile", f"probe set routed to {engine!r}"
    h = m.device_corpus(docs)
    B, L = h.chunks_d.shape
    log(f"tile path: {len(pats)} patterns, S={auto.n_states} "
        f"C={auto.n_classes} (S*C={auto.n_states * auto.n_classes}), "
        f"cascade plan {m.cascade_model.plan.mode}, engine {engine}, "
        f"{total / 2**20:.0f} MiB in rows [{B}, {L}]")
    warm = m.match_arrays(h)

    # the path, counted and timed
    sst.launches = 0
    sst.segmented_launches = 0
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(TILE_PASSES):
        res = m.match_arrays(h)
    e1.record()
    torch.cuda.synchronize()
    launches = sst.launches
    ms = e0.elapsed_time(e1) / TILE_PASSES
    assert launches >= TILE_PASSES, f"tile kernel launched {launches} times"
    assert sst.segmented_launches == launches, (
        f"only {sst.segmented_launches} of {launches} tile launches walked "
        f"the rows in segments (sync_len)")
    for key in res:
        assert np.array_equal(res[key], warm[key]), key
    n_rec = res["doc"].shape[0]
    log(f"tile path: match_arrays(handle) x {TILE_PASSES}: {ms:.3f} ms/pass "
        f"by CUDA events, {total / ms / 1e6:.3f} GB/s, {n_rec} matches/pass, "
        f"kernel launches {launches} (all with sync_len), on {card}")
    trace_breakdown(torch, lambda n: [m.match_arrays(h) for _ in range(n)],
                    card)

    # the kernel on the probe table at this shape, against plain and bound
    tm = m.tile_model
    dev = tm.device_arrays
    init = torch.zeros((B,), dtype=torch.int32, device=DEVICE)
    args = (dev["table_flat"], dev["byte_class"], dev["used_bytes"],
            h.chunks_d, init, auto.n_classes)
    sync = auto.max_len
    got = sst(*args, lengths=h.lengths_d, sync_len=sync)
    want = sst.plain(*args, h.lengths_d)
    torch.cuda.synchronize()
    err = compare(got, want, "tile kernel, probe table, 32 MiB, sync_len")
    err = max(err, compare(sst(*args, lengths=h.lengths_d), want,
                           "tile kernel, probe table, 32 MiB, whole rows"))
    k_ms = cuda_ms(lambda: sst(*args, lengths=h.lengths_d, sync_len=sync),
                   20)
    w_ms = cuda_ms(lambda: sst(*args, lengths=h.lengths_d), 20)
    p_ms = cuda_ms(lambda: sst.plain(*args, h.lengths_d), 3)
    shape = tile_launch_shape(dev["table_flat"].numel(), B, L, sync)
    b_ms, b_by, b_bytes, b_ops = in_ms(tile_bound(
        dev["table_flat"], h.chunks_d, auto.n_classes))
    states = got[0]
    c_ms = cuda_ms(lambda: compact_final_states(
        states, h.lengths_d, h.emit_from_d, dev["final_start"],
        TILE_CAPACITY), 10)
    idx, sts, n_d = compact_final_states(states, h.lengths_d, h.emit_from_d,
                                         dev["final_start"], TILE_CAPACITY)
    n = int(n_d)
    t0 = time.perf_counter()
    flat = torch.cat([idx[:n], sts[:n]]).cpu().numpy()
    f_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    expand_matches_arrays(auto, h.packed, flat[:n], flat[n:], n)
    x_ms = (time.perf_counter() - t0) * 1e3
    log(f"scan_states_tile at [{B}, {L}], sync_len {sync}: {k_ms:.4f} ms "
        f"({100 * b_ms / k_ms:.1f}% of bound; one segment a row "
        f"{w_ms:.4f} ms; plain {p_ms:.3f} ms, bound {b_ms:.4f} ms by "
        f"{b_by}: {b_bytes} bytes, {b_ops} ops) on {card}")
    log(f"scan_states_tile launch: {shape}; {ptxas}")
    log(f"tile pass parts: kernel {k_ms:.4f} ms, compaction {c_ms:.4f} ms "
        f"(device), fetch of {n} positions {f_ms:.3f} ms, host expansion "
        f"{x_ms:.3f} ms (host clock), on {card}")

    # records: host walk on 8 MiB, the dense engine on all, default capacity
    n_slice = min((8 << 20) // DOC_BYTES, len(docs))
    ref = host_walk(auto, np.frombuffer(b"".join(docs[:n_slice]), np.uint8)
                    .reshape(n_slice, DOC_BYTES))
    sel = res["doc"] < n_slice
    got_arr = np.stack([res["doc"][sel], res["pos"][sel], res["pattern"][sel]])
    assert np.array_equal(got_arr, ref), "tile: 8 MiB slice != host walk"
    md = Matcher(specs, ScanConfig(backend="device", engine="dfa",
                                   match_capacity=TILE_CAPACITY),
                 device=DEVICE)
    rd = md.match_arrays(h)
    for key in res:
        assert np.array_equal(rd[key], res[key]), f"dfa differs: {key}"
    torch.cuda.synchronize()
    e0.record()
    for _ in range(DFA_PASSES):
        md.match_arrays(h)
    e1.record()
    torch.cuda.synchronize()
    d_ms = e0.elapsed_time(e1) / DFA_PASSES
    log(f"dense engine: match_arrays(handle) equals the tile path, "
        f"{d_ms:.3f} ms/pass by CUDA events ({total / d_ms / 1e6:.3f} GB/s), "
        f"on {card}")
    trace_breakdown(torch, lambda n: [md.match_arrays(h) for _ in range(n)],
                    card, passes=1)
    mc = Matcher(specs, ScanConfig(backend="device"), device=DEVICE)
    rc = mc.match_arrays(h)
    for key in res:
        assert np.array_equal(rc[key], res[key]), f"retry differs: {key}"
    recs = m.match_many(h)
    flat_recs = [(d, r["pos"], r["keyIdx"]) for d, rs in enumerate(recs)
                 for r in rs]
    assert flat_recs == list(zip(res["doc"].tolist(), res["pos"].tolist(),
                                 res["pattern"].tolist())), "match_many"
    log(f"tile records: 8 MiB slice equals the host walk ({ref.shape[1]} "
        f"matches); dense engine and default capacity "
        f"({mc.config.match_capacity}) equal on 32 MiB; match_many's "
        f"{len(flat_recs)} dicts equal the arrays")

    # the PHP-parity functions on the card
    c = ahocorasick_init(TEST1_PATTERNS, device=DEVICE)
    c.config = ScanConfig(backend="device")
    got1 = ahocorasick_match("alFABETA gamma zetaomegaalfa!", c)
    assert c.device.type == DEVICE and c.stats.last_engine == "tile"
    assert got1 == TEST1_EXPECT and all(
        list(a) == list(b) for a, b in zip(got1, TEST1_EXPECT)), got1
    log("compat: ahocorasick_match on test1's input equals its expectation "
        "(tile engine, on the card)")
    return (specs, h, res, rd), {
        "name": "scan_states_tile",
        "route": "cuda",
        "source": "php_aho_corasick_tpu_torch/csrc/scan_states_tile.cu",
        "replaces": "php_aho_corasick_tpu/ops/scan_pallas.py:112",
        "launches": launches,
        "max_abs_err": err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    }


def signature_workload():
    """``benchmarks/bench_signatures.py --alphabet byte``'s draw of
    ``SIG_NEEDLES`` (1M) needles: 16-byte needles of
    random bytes from ``default_rng(7)`` (sorted: a set's order varies
    from run to run), then ``SIG_MIB`` MiB of random bytes from the same
    generator in 1 MiB documents, a needle planted every 1/200 of the
    corpus unless it would straddle a document.  Returns the needles, the
    documents as one ``[n_docs, 1 MiB]`` array and the planted ``(doc,
    end, pattern)`` rows."""
    rng = np.random.default_rng(7)
    raw = rng.integers(0, 256, (SIG_NEEDLES, SIG_LEN), dtype=np.uint8)
    needles = sorted({raw[i].tobytes() for i in range(SIG_NEEDLES)})
    n = SIG_MIB << 20
    corpus = rng.integers(0, 256, n, dtype=np.uint8)
    planted = []
    for j in range(0, n - SIG_LEN, n // 200):
        if j % SIG_DOC > SIG_DOC - SIG_LEN:
            continue
        pid = j % len(needles)
        corpus[j : j + SIG_LEN] = np.frombuffer(needles[pid], np.uint8)
        planted.append((j // SIG_DOC, j % SIG_DOC + SIG_LEN, pid))
    return needles, corpus.reshape(-1, SIG_DOC), planted


def host_walk_segments(auto, docs, seg=4096):
    """:func:`host_walk` over long documents cut into ``seg``-byte pieces,
    each walked from the root over the ``max_len - 1`` bytes before it
    (the state at a position depends on no earlier byte), all pieces in
    one vectorized walk: (doc, end, pattern) rows in reference order."""
    from php_aho_corasick_tpu_torch.ops.matches import csr_expand

    n_docs, n = docs.shape
    halo = auto.max_len - 1
    n_seg = -(-n // seg)
    padded = np.zeros((n_docs, halo + n_seg * seg), np.uint8)
    padded[:, halo : halo + n] = docs
    win = np.lib.stride_tricks.sliding_window_view(
        padded, halo + seg, axis=1)[:, ::seg].reshape(-1, halo + seg)
    cls = auto.byte_class[win]
    seg_of = np.arange(win.shape[0]) % n_seg
    doc_of = np.arange(win.shape[0]) // n_seg
    start = seg_of * seg  # document offset of each piece's first owned byte
    states = np.zeros(win.shape[0], np.int64)
    rows = []
    for t in range(halo + seg):
        pos = start + t - halo
        valid = (pos >= 0) & (pos < n)
        states = np.where(valid, auto.lookup(states, cls[:, t]), 0)
        if t < halo:
            continue
        fin = np.nonzero(auto.is_final(states) & valid)[0]
        if fin.size:
            rec_of, pids = csr_expand(auto, states[fin])
            src = fin[rec_of]
            rows.append(np.stack([doc_of[src], pos[src] + 1, pids]))
    arr = np.concatenate(rows, axis=1) if rows else np.zeros((3, 0), np.int64)
    order = np.lexsort((arr[1], arr[0]))  # stable: CSR order within an end
    return arr[:, order]


def phase_signature_path(torch, card):
    """Phase 9a and 9c: the 1M-needle byte signature set, whose dense
    table would exceed ``dense_table_max_bytes``, at the default config:
    the native builder's compressed table, the sampled cascade over 64 MiB
    (``match_arrays_many`` timed, counted, traced, sync-checked), every
    planted needle found, 8 MiB equal to a host walk through
    ``CompressedAutomaton.lookup``, the grouped filter's kernels against
    their plain versions at the shapes the path gives them
    (:func:`grouped_check`); then ``engine="dfa"`` (the compressed walk)
    over those 8 MiB, equal.  Returns the hand kernels' launches of the
    timed batch, the grouped kernels' times, the matcher with its
    documents and records, and the build seconds."""
    import dataclasses

    from php_aho_corasick_tpu_torch import Matcher, ScanConfig, native

    assert native.available(), "no native library"
    needles, docs2d, planted = signature_workload()
    docs = [row.tobytes() for row in docs2d]
    total = docs2d.size
    cfg = ScanConfig(backend="device", chunk_len=4096)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = Matcher([{"id": i, "value": p} for i, p in enumerate(needles)], cfg,
                device=DEVICE)
    assert isinstance(m._trie, native.NativeTrieBuilder), type(m._trie)
    m.finalize()
    build_s = time.perf_counter() - t0
    auto = m.automaton
    assert m.table_format == "compressed", m.table_format
    t0 = time.perf_counter()
    cm = m.cascade_model
    plan_s = time.perf_counter() - t0
    p = cm.plan
    assert cm._compressed and cm.records_ok and not cm.records2_ok
    assert m._pick_engine(total) == "cascade"
    t0 = time.perf_counter()
    h = m.device_corpus(docs)
    torch.cuda.synchronize()
    up_s = time.perf_counter() - t0
    B, L = h.chunks_d.shape
    route = cm.bloom_impl()
    branch = cm.take_branch(L) if route == "take" else "bank bloom"
    log(f"signature-byte: {len(needles)} needles x {SIG_LEN} random bytes, "
        f"table_format {m.table_format}: {auto.n_states} states ({auto.n_dense}"
        f" dense rows, {auto.n_states - auto.n_dense} sparse) x "
        f"{auto.n_classes} classes, table {auto.table_bytes} bytes (dense "
        f"would be {auto.n_states * auto.n_classes * 4}); build "
        f"{build_s:.2f} s, plan {plan_s:.2f} s (host clock); plan "
        f"{p.reason}, 2^{p.log2_words}-word positional bloom, prefix bloom "
        f"2^{p.prefix_log2} words, bank bloom "
        f"{'none' if p.vmem_words is None else p.vmem_words.shape}, win_len "
        f"{cm.win_len}, records {cm.records_ok}, records2 {cm.records2_ok}, "
        f"filter {route} ({branch}); {total / 2**20:.0f} MiB in rows "
        f"[{B}, {L}], upload {up_s:.2f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes; on {card}")

    def no_host_verify(*args, **kw):
        raise AssertionError("the records path reached host verify_arrays")

    cm.verify_arrays = no_host_verify
    warm = m.match_arrays(h)
    m.match_arrays_many([h] * BATCH)  # warm the batch structure
    fallbacks = m.stats.records_fallbacks
    torch.cuda.reset_peak_memory_stats()
    before = launch_counts()
    ms, res, wall = timed_passes(
        torch, lambda: m.match_arrays_many([h] * BATCH), 1)
    ms, wall = ms / BATCH, wall / BATCH
    launched = launch_counts(before)
    peak = torch.cuda.max_memory_allocated()
    assert m.stats.records_fallbacks == fallbacks, "batch fell back"
    for r in res:
        for key in r:
            assert np.array_equal(r[key], warm[key]), key
    found = set(zip(res[0]["doc"].tolist(), res[0]["pos"].tolist(),
                    res[0]["pattern"].tolist()))
    missing = [x for x in planted if x not in found]
    assert not missing, f"signature-byte: planted not found: {missing[:5]}"
    n_rec = res[0]["doc"].shape[0]
    cap_a, cap_r = cm.learned_caps
    f_ms = cuda_ms(lambda: cm.scan_hits_sampled(
        h.chunks_d, h.lengths_d, cap_a), 5)
    c_ms = cuda_ms(lambda: cm.launch_device_records(
        h.chunks_d, h.lengths_d, h.emit_from_d, cap_a, cap_r), 5)
    log(f"signature-byte: match_arrays_many([handle] * {BATCH}) over "
        f"{total / 2**20:.0f} MiB: {ms:.3f} ms/pass by CUDA events "
        f"({wall:.3f} ms wall), {total / ms / 1e6:.2f} GB/s; "
        f"{len(planted)}/{len(planted)} planted needles found, {n_rec} "
        f"matches/pass; hand kernel launches {launched}; "
        f"device time of the filter "
        f"{f_ms:.3f} ms, of filter + record verify {c_ms:.3f} ms (capacity "
        f"{cap_a}); peak device memory {peak} bytes; on {card}")
    trace_breakdown(torch, lambda n: m.match_arrays_many([h] * n), card,
                    passes=1)
    # the grouped filter's kernels at the shapes this path gives them
    times = grouped_check(
        torch, card, "signature-byte",
        lambda: cm.scan_hits_sampled(h.chunks_d, h.lengths_d, cap_a))
    # the batch's halves on the host clock: the dispatch of every launch,
    # the wait for the device, the fetch of the records and their expansion
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pending = m._records_batch_dispatch([h] * BATCH, cm)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    m._records_batch_finish(*pending, True)
    t3 = time.perf_counter()
    log(f"signature-byte batch parts, ms a pass (host clock): dispatch "
        f"{(t1 - t0) * 1e3 / BATCH:.3f}, wait for the device "
        f"{(t2 - t1) * 1e3 / BATCH:.3f}, fetch + expansion "
        f"{(t3 - t2) * 1e3 / BATCH:.3f}; on {card}")
    pending = assert_no_sync(
        torch, lambda: m._records_batch_dispatch([h] * 2, cm))
    m._records_batch_finish(*pending, True)
    log("sync check (set_sync_debug_mode='error'): no host sync in the "
        "signature-byte dispatch")

    # 8 MiB against a host walk through CompressedAutomaton.lookup
    n_slice = (8 << 20) // SIG_DOC
    t0 = time.perf_counter()
    ref = host_walk_segments(auto, docs2d[:n_slice])
    walk_s = time.perf_counter() - t0
    sel = res[0]["doc"] < n_slice
    got = np.stack([res[0][k][sel] for k in ("doc", "pos", "pattern")])
    assert np.array_equal(got, ref), "signature-byte: 8 MiB != host walk"
    log(f"signature-byte: 8 MiB slice equals the host walk through "
        f"CompressedAutomaton.lookup ({ref.shape[1]} matches, "
        f"{walk_s:.1f} s host)")

    # 9c. the compressed dfa engine over the same 8 MiB
    h8 = m.device_corpus(docs[:n_slice])
    m.config = dataclasses.replace(cfg, engine="dfa")
    assert m._pick_engine(h8.total_bytes) == "dfa"
    before = launch_counts()
    d_ms, rdfa, d_wall = timed_passes(torch, lambda: m.match_arrays(h8), 1)
    d_launched = launch_counts(before)
    m.config = cfg
    want = {k: res[0][k][sel] for k in res[0]}
    for key in want:
        assert np.array_equal(rdfa[key], want[key]), f"compressed dfa: {key}"
    log(f"compressed dfa engine: match_arrays over {h8.total_bytes / 2**20:.0f}"
        f" MiB equals the cascade's records ({rdfa['doc'].shape[0]} "
        f"matches); {d_ms:.3f} ms by CUDA events ({d_wall:.3f} ms wall), "
        f"{h8.total_bytes / d_ms / 1e6:.3f} GB/s, rows "
        f"{tuple(h8.chunks_d.shape)}, hand kernel launches {d_launched}; on "
        f"{card}")
    assert min(launched["grouped_take_extract"],
               launched["grouped_take_refine"]) >= BATCH, launched
    return launched, times, (m, docs, res[0], rdfa, n_slice), build_s


def phase_compressed_path(torch, card, head):
    """Phase 9b and 9d: the headline set with ``table_format="compressed"``
    on phase 4's planted 64 MiB handle (the bank-bloom records chain with
    the compressed walk), equal to the dense matcher's records and timed;
    then ``CascadeModel.launch_device`` (the flagged-window verify) on the
    dense and the compressed models over that handle, whose
    ``emit_windows_arrays`` equal the records path.  Returns the hand
    kernels' launches of the timed batch and the fused kernel's largest
    difference from its plain version at this handle's shape."""
    from php_aho_corasick_tpu_torch import Matcher, ScanConfig

    needles, md, hd, rd = head
    mc = Matcher([{"id": i, "value": p} for i, p in enumerate(needles)],
                 ScanConfig(backend="device", chunk_len=4096,
                            table_format="compressed"), device=DEVICE)
    cc = mc.cascade_model
    auto = mc.automaton
    assert mc.table_format == "compressed" and cc._compressed
    assert cc.bloom_impl() == "pallas_vmem" and cc.records_ok
    assert hd.fused_phases(cc) is not None
    warm = mc.match_arrays(hd)
    for key in rd:
        assert np.array_equal(warm[key], rd[key]), f"compressed: {key}"
    mc.match_arrays_many([hd] * BATCH)
    fallbacks = mc.stats.records_fallbacks
    before = launch_counts()
    ms, res, wall = timed_passes(
        torch, lambda: mc.match_arrays_many([hd] * BATCH), 1)
    ms, wall = ms / BATCH, wall / BATCH
    launched = launch_counts(before)
    assert launched["fused_sampled_extract"] >= BATCH, launched
    assert mc.stats.records_fallbacks == fallbacks, "batch fell back"
    for r in res:
        for key in r:
            assert np.array_equal(r[key], rd[key]), key
    log(f"headline-compressed: {auto.n_states} states ({auto.n_dense} dense "
        f"rows), table {auto.table_bytes} bytes; match_arrays_many([planted "
        f"{hd.total_bytes / 2**20:.0f} MiB handle] * {BATCH}): {ms:.3f} "
        f"ms/pass by CUDA events "
        f"({wall:.3f} ms wall), {res[0]['doc'].shape[0]} matches/pass equal "
        f"to the dense matcher's, hand kernel launches {launched}; on "
        f"{card}")
    trace_breakdown(torch, lambda n: mc.match_arrays_many([hd] * n), card,
                    passes=1)
    # the fused kernel at this handle's shape, against its plain version
    from php_aho_corasick_tpu_torch.ops.filter_cuda import (
        fused_sampled_extract as fse,
    )

    args, kw = extract_args(cc, hd)
    got, want = fse(*args, **kw), fse.plain(*args, **kw)
    torch.cuda.synchronize()
    err = compare(got, want, "fused, headline-compressed, planted 64 MiB")
    log(f"fused_sampled_extract at the planted handle's shape (n_grid "
        f"{kw['n_grid']}): bit-equal to its plain version; on {card}")

    # 9d. the flagged-window verify on both tables
    for name, cmx in (("dense", md.cascade_model), ("compressed", cc)):
        phase_g = hd.fused_phases(cmx)

        def launch(cap_a, cap_b):
            cells, n_d, nf_d, nc_d = cmx.launch_device(
                hd.chunks_d, hd.lengths_d, cap_a, cap_b, phase_g=phase_g)
            n, nf, nc = torch.stack([n_d, nf_d, nc_d]).tolist()
            return cells, n, nf, nc

        cells, nf = cmx.adaptive_chain(launch)
        cap_a, cap_b = cmx.learned_caps
        l_ms = cuda_ms(lambda: cmx.launch_device(
            hd.chunks_d, hd.lengths_d, cap_a, cap_b, phase_g=phase_g), 3)
        t0 = time.perf_counter()
        arrays = cmx.emit_windows_arrays(hd.packed, cells[:nf].cpu().numpy(),
                                         nf)
        e_ms = (time.perf_counter() - t0) * 1e3
        for key, a in zip(("doc", "pos", "pattern"), arrays):
            assert np.array_equal(a, rd[key]), f"launch_device {name}: {key}"
        log(f"launch_device ({name} table, verify_kv {cmx.verify_kv}): "
            f"{nf} flagged windows, emit_windows_arrays equals the records "
            f"path ({arrays[0].shape[0]} matches); filter + flagged verify "
            f"{l_ms:.3f} ms device time (capacity {cap_a}), host re-walk "
            f"{e_ms:.1f} ms; on {card}")
    return launched, err


def phase_kgram_path(torch, card, tile_cell):
    """Phase 9e: ``engine="kgram"`` on phase 5's 32 MiB tile handle (184
    states x 7 classes: k = 4 under the 256 MiB budget), timed, equal to
    the tile and the dense engines on all 32 MiB.  Returns the hand
    kernels' launches of the timed passes."""
    from php_aho_corasick_tpu_torch import Matcher, ScanConfig

    specs, h, res_tile, res_dfa = tile_cell
    mk = Matcher(specs, ScanConfig(backend="device", engine="kgram",
                                   match_capacity=TILE_CAPACITY),
                 device=DEVICE)
    km = mk.kgram_model
    assert km.k == 4, km.k
    assert mk._pick_engine(h.total_bytes) == "kgram"
    warm = mk.match_arrays(h)
    before = launch_counts()
    ms, res, wall = timed_passes(torch, lambda: mk.match_arrays(h),
                                 KGRAM_PASSES)
    launched = launch_counts(before)
    for want, what in ((res_tile, "tile"), (res_dfa, "dense")):
        for key in want:
            assert np.array_equal(res[key], want[key]), f"kgram/{what}: {key}"
            assert np.array_equal(warm[key], want[key]), f"kgram/{what}: {key}"
    kt = km.device_arrays["ktable"]
    log(f"k-gram engine: k {km.k}, table {kt.numel()} x {kt.dtype} "
        f"({kt.numel() * kt.element_size()} bytes); match_arrays(tile handle)"
        f" x {KGRAM_PASSES}: {ms:.3f} ms/pass by CUDA events ({wall:.3f} ms "
        f"wall), {h.total_bytes / ms / 1e6:.3f} GB/s, {res['doc'].shape[0]} "
        f"matches/pass equal to the tile and dense engines on all "
        f"{h.total_bytes / 2**20:.0f} MiB; hand kernel launches {launched}; "
        f"on {card}")
    trace_breakdown(torch, lambda n: [mk.match_arrays(h) for _ in range(n)],
                    card, passes=1)
    # one pass in parts (host clock): the dispatch of the walk, the wait
    # for the device, the fetch of the flagged cells, their host re-walk
    from php_aho_corasick_tpu_torch.ops.matches import (
        expand_matches_kgram_arrays,
    )

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cells, prevs, n_d, _ = km.scan_compact_device(
        h.chunks_d, h.lengths_d, h.emit_from_d, None, TILE_CAPACITY)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    n = int(n_d)
    flat = torch.cat([cells[:n], prevs[:n]]).cpu().numpy()
    t3 = time.perf_counter()
    expand_matches_kgram_arrays(mk.automaton, h.packed, km.k, flat[:n],
                                flat[n:], n)
    t4 = time.perf_counter()
    log(f"k-gram pass parts, ms (host clock): dispatch {(t1 - t0) * 1e3:.3f}"
        f", wait for the device {(t2 - t1) * 1e3:.3f}, fetch of {n} flagged "
        f"cells {(t3 - t2) * 1e3:.3f}, host re-walk and expansion "
        f"{(t4 - t3) * 1e3:.3f}; on {card}")
    return launched


def same_arrays(got, want, what):
    for key in want:
        assert np.array_equal(got[key], want[key]), f"{what}: {key}"


def stream_records(m, text, feed):
    """``m.stream()`` fed ``text`` ``feed`` bytes at a time: the records,
    CUDA-event ms and host-clock ms of the whole stream."""
    import torch

    def run():
        with m.stream() as st:
            return [r for o in range(0, len(text), feed)
                    for r in st.feed(text[o : o + feed])]

    ms, recs, wall = timed_passes(torch, run, 1)
    return recs, ms, wall


def rec_rows(recs):
    """``(end, pattern)`` rows of record dicts made from ``{"id": i}``
    specs."""
    return np.array([(r["pos"], r["keyIdx"]) for r in recs],
                    np.int64).reshape(-1, 2)


def phase_serving_path(torch, card, head, tile_cell, base):
    """Phase 10: the serving and streaming surface.  (a) the fresh-corpus
    pipeline: ``match_arrays`` over the headline's 128 MiB as 16,384 fresh
    8 KiB documents (8 slices of 16 MiB), beside the same call with the
    pipeline off and ``device_corpus`` + ``match_arrays``, and over phase
    4's planted documents, equal to its records; (b) ``match_arrays_stream``
    over 6 batches of ``[handle] * 2`` (headline, planted) against 6
    sequential ``match_arrays_many`` calls, its dispatch sync-checked; (c)
    a stream over the planted 64 MiB joined, 4 MiB feeds through the
    cascade's prefix re-scan, a needle planted across every feed boundary;
    (d) the dense device carry on the tile cell's automaton over 8 MiB in
    1 MiB feeds, ``Matcher.match`` replaced by a raiser; (e)
    ``iter_matches`` over (c)'s bytes; (f) ``replace`` and
    ``replace_stream`` over (c)'s bytes; (g) ``warmup`` and one
    ``match_many`` at its shape.  Returns the hand kernels' launches of the
    phase and the fused kernel's largest difference from its plain version
    at a fresh slice's shape."""
    import dataclasses

    from php_aho_corasick_tpu_torch import Matcher, ScanConfig
    from php_aho_corasick_tpu_torch import stream as stream_mod

    needles, m, h, hd, rd = head
    cfg = m.config
    cm = m.cascade_model
    length = len(needles[0])
    docs = [row.tobytes() for row in base] * HEADLINE_REPS
    total = sum(map(len, docs))
    dens, planted = planted_docs(needles, base, int(DENSITY * 1e9))
    before = launch_counts()

    # (a) the fresh-corpus pipeline, off, and the resident handle
    def fresh():
        return m.match_arrays(docs)

    want = fresh()
    assert m.stats.last_engine == "cascade-fresh", m.stats.last_engine
    n_slices = -(-total // min(cfg.fresh_slice_bytes,
                               cfg.max_launch_bytes // 2))
    calls = {  # name: (config, call, the engine it records)
        "on": (cfg, fresh, "cascade-fresh"),
        "off": (dataclasses.replace(cfg, fresh_slice_bytes=total), fresh,
                "arrays"),
        "handle": (cfg, lambda: m.match_arrays(m.device_corpus(docs)),
                   "arrays"),
    }
    runs = {}
    for name in ("on", "off", "handle") * 2:
        m.config, run, engine = calls[name]
        try:
            ms, res, wall = timed_passes(torch, run, FRESH_PASSES)
        finally:
            m.config = cfg
        assert m.stats.last_engine == engine, (name, m.stats.last_engine)
        same_arrays(res, want, f"fresh {name}")
        runs.setdefault(name, []).append((ms, wall))
    log(f"fresh corpus: match_arrays over {len(docs)} fresh "
        f"{DOC_BYTES // 1024} KiB documents ({total / 2**20:.0f} MiB, "
        f"{n_slices} slices of {cfg.fresh_slice_bytes / 2**20:.0f} MiB), "
        f"ms a call by CUDA events (host clock) in turns on, off, handle, "
        f"on, off, handle: "
        + "; ".join(f"{k} " + ", ".join(f"{a:.3f} ({b:.3f})" for a, b in v)
                    for k, v in runs.items())
        + f"; {want['doc'].shape[0]} matches, equal; on {card}")
    pd = [row.tobytes() for row in dens]
    res = m.match_arrays(pd)
    assert m.stats.last_engine == "cascade-fresh"
    same_arrays(res, rd, "fresh planted")
    log(f"fresh corpus over phase 4's planted {dens.size / 2**20:.0f} MiB "
        f"({len(pd)} documents): equal to phase 4's records array for "
        f"array ({res['doc'].shape[0]} matches)")
    trace_breakdown(torch, lambda n: [fresh() for _ in range(n)], card,
                    passes=1, top=10)

    # (b) the cross-batch double buffer against sequential batches
    for name, hx in (("headline", h), ("planted", hd)):
        batches = [[hx] * 2 for _ in range(STREAM_BATCHES)]
        one = m.match_arrays_many(batches[0])
        real = m._records_batch_dispatch
        m._records_batch_dispatch = lambda hs, c: assert_no_sync(
            torch, lambda: real(hs, c))
        try:
            got = list(m.match_arrays_stream(batches))
        finally:
            del m._records_batch_dispatch
        assert len(got) == STREAM_BATCHES
        for b in got:
            for r, w in zip(b, one):
                same_arrays(r, w, f"stream of batches, {name}")
        turns = []
        for kind in ("sequential", "stream", "stream", "sequential"):
            run = (lambda: [m.match_arrays_many(b) for b in batches]) \
                if kind == "sequential" \
                else (lambda: list(m.match_arrays_stream(batches)))
            ms, _, wall = timed_passes(torch, run, 1)
            turns.append(f"{kind} {ms:.3f} ({wall:.3f})")
        log(f"match_arrays_stream, {STREAM_BATCHES} batches of [{name} "
            f"handle] * 2, each equal to match_arrays_many "
            f"({one[0]['doc'].shape[0]} matches a handle), no host sync in "
            f"its dispatch; ms for all {STREAM_BATCHES} batches by CUDA "
            f"events (host clock), in turns: {'; '.join(turns)}; on {card}")

    # (c) one stream over the planted corpus, a needle across each boundary
    joined = dens.reshape(-1).copy()
    prng = random.Random(29)
    boundary = []
    for b in range(STREAM_FEED, joined.size, STREAM_FEED):
        o = b - prng.randrange(1, length)
        pid = prng.randrange(len(needles))
        joined[o : o + length] = np.frombuffer(needles[pid], np.uint8)
        boundary.append((o + length, pid))
    text = joined.tobytes()
    expect = [(d * DOC_BYTES + o + length, p) for d, o, p in planted]
    expect = [(e, p) for e, p in expect
              if text[e - length : e] == needles[p]] + boundary
    recs, ms, wall = stream_records(m, text, STREAM_FEED)
    assert m.stats.last_engine == "cascade", m.stats.last_engine
    rows = rec_rows(recs)
    found = set(map(tuple, rows.tolist()))
    missing = [x for x in expect if x not in found]
    assert not missing, f"stream: planted needles not found: {missing[:5]}"
    ref = host_walk_segments(m.automaton, joined[None, :8 << 20])
    sel = rows[:, 0] <= 8 << 20
    assert np.array_equal(rows[sel].T, ref[1:]), "stream: 8 MiB != host walk"
    n_feeds = -(-len(text) // STREAM_FEED)
    log(f"stream (prefix re-scan through the cascade): {len(text) / 2**20:.0f}"
        f" MiB in {n_feeds} feeds of {STREAM_FEED >> 20} MiB, {len(recs)} "
        f"records, {len(expect)} planted ({len(boundary)} across feed "
        f"boundaries) all found at their global offsets, 8 MiB equal to the "
        f"host walk; {ms:.3f} ms by CUDA events ({wall:.3f} ms host clock), "
        f"{ms / n_feeds:.3f} ms a feed; on {card}")

    # (d) the dense device carry on the tile cell's automaton
    specs = tile_cell[0]
    mt = Matcher(specs, ScanConfig(backend="device",
                                   match_capacity=TILE_CAPACITY),
                 device=DEVICE)
    assert mt._pick_engine(CARRY_FEED) == "tile"

    def raiser(*args, **kw):
        raise AssertionError("prefix path engaged on a device-carry feed")

    mt.match = raiser
    carried = np.tile(base.reshape(-1), -(-CARRY_BYTES // base.size))
    carried = carried[:CARRY_BYTES]
    recs_t, ms, wall = stream_records(mt, carried.tobytes(), CARRY_FEED)
    ref = host_walk_segments(mt.automaton, carried[None])
    assert np.array_equal(rec_rows(recs_t).T, ref[1:]), \
        "device carry != host walk"
    n_feeds = CARRY_BYTES // CARRY_FEED
    log(f"stream (dense device carry, tile cell's automaton): "
        f"{CARRY_BYTES >> 20} MiB in {n_feeds} feeds of "
        f"{CARRY_FEED >> 20} MiB, {len(recs_t)} records equal to the host "
        f"walk; {ms / n_feeds:.3f} ms a feed by CUDA events "
        f"({wall / n_feeds:.3f} ms host clock); on {card}")

    # (e) iter_matches over (c)'s bytes
    seg = 1 << 20
    w0 = time.perf_counter()
    assert list(m.iter_matches(text)) == recs, "iter_matches != stream"
    it_ms = (time.perf_counter() - w0) * 1e3
    calls = []
    real_feed = stream_mod.StreamScanner.feed

    def spy(self, data):
        calls.append(len(data))
        return real_feed(self, data)

    stream_mod.StreamScanner.feed = spy
    try:
        first = list(m.iter_matches(text, find_all=False))
    finally:
        stream_mod.StreamScanner.feed = real_feed
    first_pos = recs[0]["pos"]
    assert first == [r for r in recs if r["pos"] == first_pos]
    assert len(calls) == -(-first_pos // seg), (len(calls), first_pos)
    log(f"iter_matches over (c)'s bytes ({seg >> 20} MiB segments): equal "
        f"to the stream's records, {it_ms:.3f} ms host clock; find_all=False"
        f" stopped after {len(calls)} feeds (first match ends at "
        f"{first_pos})")

    # (f) replace: one-shot, streamed NORMAL and LAZY, and a splice of (c)
    rmap = {needles[p]: b"<%d>" % p for p in range(0, len(needles), 3)}
    out, cur, n_rep = bytearray(), 0, 0
    for end, pid in rows.tolist():  # 16-byte needles: no nested matches
        if needles[pid] in rmap:
            if end - length > cur:
                out += text[cur : end - length]
            out += rmap[needles[pid]]
            cur = max(cur, end)
            n_rep += 1
    out += text[cur:]
    times = []
    for mode in ("normal", "lazy"):
        w0 = time.perf_counter()
        one = m.replace(text, rmap, mode)
        w1 = time.perf_counter()
        rs = m.replace_stream(rmap, mode)
        got = bytearray()
        for o in range(0, len(text), STREAM_FEED):
            got += rs.feed(text[o : o + STREAM_FEED])
        got += rs.flush()
        w2 = time.perf_counter()
        assert bytes(got) == one, f"replace_stream {mode} != replace"
        if mode == "normal":
            assert one == bytes(out), "replace != splice of the records"
        times.append(f"{mode} one-shot {(w1 - w0) * 1e3:.3f}, stream "
                     f"{(w2 - w1) * 1e3:.3f}")
    assert n_rep >= len(expect) // 5, n_rep  # a third of the needles
    log(f"replace over (c)'s bytes, {len(rmap)} needles with replacements, "
        f"{n_rep} records replaced: replace_stream ({STREAM_FEED >> 20} MiB "
        f"feeds) equals replace in both modes, NORMAL equals a splice of "
        f"(c)'s records; ms host clock: {'; '.join(times)}; on {card}")

    # (g) warmup, then one match_many at its shape
    w0 = time.perf_counter()
    m.warmup(WARMUP_DOC, WARMUP_DOCS)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - w0) * 1e3
    wdocs = [text[i * WARMUP_DOC : (i + 1) * WARMUP_DOC]
             for i in range(WARMUP_DOCS)]
    ms, res, wall = timed_passes(torch, lambda: m.match_many(wdocs), 1)
    for i, got in enumerate(res):
        lo, hi = i * WARMUP_DOC, (i + 1) * WARMUP_DOC
        want_i = [(r["pos"] - lo, r["keyIdx"]) for r in recs
                  if r["start_postion"] >= lo and r["pos"] <= hi]
        assert rec_rows(got).tolist() == [list(x) for x in want_i], i
    log(f"warmup({WARMUP_DOC}, {WARMUP_DOCS}): {warm_ms:.3f} ms host clock; "
        f"then match_many over {WARMUP_DOCS} documents of "
        f"{WARMUP_DOC >> 20} MiB: {ms:.3f} ms by CUDA events ({wall:.3f} ms "
        f"host clock), engine {m.stats.last_engine}, records equal to (c)'s; "
        f"on {card}")
    launched = launch_counts(before)
    assert launched["fused_sampled_extract"] > 0, launched
    log(f"phase 10 hand kernel launches: {launched}")

    # the fused kernel at a fresh slice's shape, against its plain version
    from php_aho_corasick_tpu_torch.ops.filter_cuda import (
        fused_sampled_extract as fse,
    )

    hs = m.device_corpus(docs[: cfg.fresh_slice_bytes // DOC_BYTES])
    args, kw = extract_args(cm, hs)
    got, want = fse(*args, **kw), fse.plain(*args, **kw)
    torch.cuda.synchronize()
    err = compare(got, want, "fused, a fresh slice")
    log(f"fused_sampled_extract at a fresh slice's shape (rows "
        f"{tuple(hs.chunks_d.shape)}): bit-equal to its plain version")
    return launched, err


SHARDS = 4  # phase 11: shards of the one card
TWO_PROC_REPS, TWO_PROC_SHARDS = 8, 2  # 16 MiB of planted docs; shards a rank


def shard_split(packed, res, n_shards):
    """Matches of ``res`` per shard, by the row that owns each match's end
    (rows split into ``n_shards`` contiguous blocks)."""
    rows = np.nonzero(packed.lengths > 0)[0]
    key_rows = (packed.doc_id[rows].astype(np.int64) << 40) | (
        packed.global_off[rows] + packed.emit_from[rows])
    key = (res["doc"].astype(np.int64) << 40) | (res["pos"] - 1)
    owner = rows[np.searchsorted(key_rows, key, side="right") - 1]
    return np.bincount(owner // (packed.batch // n_shards),
                       minlength=n_shards)


def two_process_docs(reps):
    """Phase 11e's corpus: ``reps`` x 2 MiB of the base documents with the
    headline needles planted at ``DENSITY``, and the needles."""
    needles, base = workload()
    dens, _ = planted_docs(needles, base, int(DENSITY * 1e9) + 2, reps)
    return needles, [row.tobytes() for row in dens]


def two_process_worker(addr, rank, device, reps):
    """One of the two ranks of phase 11e: joins a gloo group at ``addr``,
    shards ``two_process_docs(reps)`` over ``TWO_PROC_SHARDS`` shards of
    ``device`` a process and prints its record count and a digest of the
    records."""
    import hashlib

    import torch.distributed as dist

    from php_aho_corasick_tpu_torch import Matcher, ScanConfig
    from php_aho_corasick_tpu_torch.parallel.mesh import (
        data_mesh, init_distributed, local_shards,
    )

    init_distributed(addr, 2, rank, backend="gloo")
    needles, docs = two_process_docs(reps)
    m = Matcher([{"id": i, "value": p} for i, p in enumerate(needles)],
                ScanConfig(backend="device", chunk_len=4096), device=device)
    with local_shards(TWO_PROC_SHARDS):
        mesh = data_mesh(device=m.device)
        hs = m.device_corpus(docs, shard=True)
        res = m.match_arrays_many([hs])[0]
    digest = hashlib.sha256(b"".join(
        res[k].tobytes() for k in ("doc", "pos", "pattern"))).hexdigest()
    print(f"TWO-PROC rank={rank} backend={dist.get_backend()} "
          f"shards={len(mesh)} local={mesh.n_local} "
          f"records={res['doc'].shape[0]} digest={digest[:16]}", flush=True)
    dist.destroy_process_group()
    return 0


def phase_two_processes(torch, card, m):
    """Phase 11e: two ranks on the one card through ``torch.distributed``
    with gloo (NCCL cannot pair two ranks on one device), each holding
    its own shards' rows; both must report the single-process records."""
    import hashlib
    import socket

    _, docs = two_process_docs(TWO_PROC_REPS)
    res = m.match_arrays(m.device_corpus(docs, shard=False))
    assert res["doc"].shape[0] > 0
    digest = hashlib.sha256(b"".join(
        res[k].tobytes() for k in ("doc", "pos", "pattern"))).hexdigest()
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--worker", f"127.0.0.1:{port}",
         str(rank), DEVICE, str(TWO_PROC_REPS)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    outs = []
    try:
        for pr in procs:
            outs.append(pr.communicate(timeout=300)[0])
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    lines = []
    for rank, (pr, out) in enumerate(zip(procs, outs)):
        assert pr.returncode == 0, f"rank {rank} failed:\n{out}"
        line = [ln for ln in out.splitlines() if ln.startswith("TWO-PROC")]
        assert len(line) == 1, out
        lines.append(line[0])
        log(f"  {line[0]}")
    want = (f"backend=gloo shards={2 * TWO_PROC_SHARDS} "
            f"local={TWO_PROC_SHARDS} records={res['doc'].shape[0]} "
            f"digest={digest[:16]}")
    for rank, line in enumerate(lines):
        assert line == f"TWO-PROC rank={rank} {want}", (line, want)
    log(f"two processes (torch.distributed, gloo, both ranks on {m.device}, "
        f"{2 * TWO_PROC_SHARDS} shards over "
        f"{sum(map(len, docs)) / 2**20:.0f} MiB): both report "
        f"{res['doc'].shape[0]} records, digest equal to the "
        f"single-process result; on {card}")


def phase_shard_path(torch, card, head, planted, tile_cell, sig, base):
    """Phase 11: the data mesh, ``SHARDS`` shards of the one card.  (a)
    the headline's 128 MiB through ``device_corpus(shard=True)`` and
    ``match_arrays_many([handle] * 12)``: records equal to the unsharded
    handle's, per-shard record counts equal to a host split of them, ms a
    pass by CUDA events in turns with the unsharded handle, launches a pass
    by trace, no host sync in the sharded dispatch; (b) phase 4's planted
    64 MiB sharded: every planted needle found, records equal to phase
    4's, per-shard record counts equal to a host split; (c) ``match_arrays`` sharded through the tile, dfa, k-gram,
    anchored, rows, take-flat (the rows set on the flat take filter),
    take-grouped, headline-compressed and signature-byte cells, each equal to its unsharded records, the compressed table held
    once on the card; (d) ``dryrun_multichip(SHARDS, "cuda")``; (e) two
    processes on the card over 16 MiB of planted documents.  Every launch
    of (a)'s call and of the cells of (c) that name a kernel, at a shard's
    shape, is held against its plain version.  Returns the hand kernels'
    launches of the phase."""
    import dataclasses

    from php_aho_corasick_tpu_torch import Matcher, ScanConfig
    from php_aho_corasick_tpu_torch.ops.filter_cuda import (
        fused_sampled_extract as fse,
    )
    from php_aho_corasick_tpu_torch.parallel.dryrun import dryrun_multichip
    from php_aho_corasick_tpu_torch.parallel.mesh import local_shards

    needles, m, h, warm = head
    hd, rd = planted
    cm = m.cascade_model
    launches0 = launch_counts()
    with local_shards(SHARDS):
        # (a) the headline, sharded
        docs = [row.tobytes() for row in base] * HEADLINE_REPS
        hs = m.device_corpus(docs, shard=True)
        assert len(hs.mesh) == SHARDS and len(hs.chunks_d) == SHARDS
        assert all(c.device == h.chunks_d.device for c in hs.chunks_d)
        res, calls = held_calls(lambda: m.match_arrays(hs),
                                "fused_sampled_extract")
        same_arrays(res, warm, "sharded headline")
        call = calls["fused_sampled_extract"][0]
        log(f"phase 11a: headline sharded over {SHARDS} shards of "
            f"{hs.mesh.home}: rows {[tuple(c.shape) for c in hs.chunks_d]}; "
            f"fused_sampled_extract at a shard's phases "
            f"{tuple(call[0][1].shape)}: bit-equal to its plain version")
        m.match_arrays_many([hs] * BATCH)  # warm the batch structure
        turns = []
        for who, hh in (("sharded", hs), ("unsharded", h)) * 2:
            n0 = fse.launches
            ms, r, wall = timed_passes(
                torch, lambda: m.match_arrays_many([hh] * BATCH), 1)
            turns.append((who, ms / BATCH, wall / BATCH,
                          (fse.launches - n0) / BATCH))
            for x in r:
                same_arrays(x, warm, f"{who} headline batch")
        for who, ms, wall, nf in turns:
            log(f"  {who}: {ms:.3f} ms/pass by CUDA events ({wall:.3f} ms "
                f"host clock), {hs.total_bytes / ms / 1e6:.2f} GB/s, "
                f"fused_sampled_extract launches/pass {nf:.0f}; on {card}")
        pending = assert_no_sync(
            torch, lambda: m._records_batch_sharded_dispatch([hs] * 2, cm))
        nrs = pending[5].cpu().numpy()[:, 6:]
        m._records_batch_sharded_finish(*pending, True)
        split = shard_split(hs.packed, warm, SHARDS)
        assert all(x.tolist() == split.tolist() for x in nrs), (nrs, split)
        log(f"phase 11a: per-shard record counts {split.tolist()} equal the "
            f"host split of the records ({warm['doc'].shape[0]}); sync check"
            f" (set_sync_debug_mode='error'): no host sync in the sharded "
            f"dispatch")
        for who, hh in (("sharded", hs), ("unsharded", h)):
            log(f"  trace, {who}:")
            trace_breakdown(torch, lambda n: m.match_arrays_many([hh] * n),
                            card)

        # (b) phase 4's planted corpus, sharded
        dens, plants = planted_docs(needles, base, int(DENSITY * 1e9))
        hds = m.device_corpus([row.tobytes() for row in dens], shard=True)
        rds = m.match_arrays_many([hds])[0]
        same_arrays(rds, rd, "sharded planted")
        found = set(zip(rds["doc"].tolist(), rds["pos"].tolist(),
                        rds["pattern"].tolist()))
        length = len(needles[0])
        intact = [(d, o + length, p) for d, o, p in plants
                  if dens[d, o : o + length].tobytes() == needles[p]]
        assert all(x in found for x in intact), "sharded planted: missing"
        pending = m._records_batch_sharded_dispatch([hds], cm)
        nrs = pending[5].cpu().numpy()[0, 6:]
        m._records_batch_sharded_finish(*pending, True)
        split = shard_split(hds.packed, rds, SHARDS)
        assert nrs.tolist() == split.tolist(), (nrs, split)
        log(f"phase 11b: planted 64 MiB sharded: {len(plants)} planted, "
            f"{len(intact)} intact all found, {rds['doc'].shape[0]} records "
            f"equal to phase 4's; per-shard record counts {split.tolist()} "
            f"equal the host split of the records")

        # (c) every engine, sharded, against its unsharded records
        def cell(name, mm, hh, want, *held):
            t0 = time.perf_counter()
            # every launch held, the kernels ``held`` at least once a shard
            got, calls = held_calls(lambda: mm.match_arrays(hh), *held)
            for n, c in calls.items():
                assert len(c) >= len(hh.mesh), (n, len(c))
            wall = (time.perf_counter() - t0) * 1e3
            same_arrays(got, want, f"sharded {name}")
            log(f"phase 11c: {name} sharded "
                f"({mm._pick_engine(hh.total_bytes)}, "
                f"{hh.total_bytes / 2**20:.0f} MiB, {len(hh.mesh)} shards): "
                f"{got['doc'].shape[0]} records equal to unsharded; "
                f"{wall:.1f} ms host clock"
                + (f"; {', '.join(held)} (every launch) at a shard's shape "
                   f"bit-equal to plain" if held else ""))
            return got

        specs, th, res_tile, res_dfa = tile_cell
        tdocs = [row.tobytes() for row in base] * TILE_REPS
        mt = Matcher(specs, ScanConfig(backend="device",
                                       match_capacity=TILE_CAPACITY),
                     device=DEVICE)
        cell("tile", mt, mt.device_corpus(tdocs, shard=True), res_tile,
             "scan_states_tile")
        n8 = (8 << 20) // DOC_BYTES
        md = Matcher(specs, ScanConfig(backend="device", engine="dfa",
                                       match_capacity=TILE_CAPACITY),
                     device=DEVICE)
        sel = res_dfa["doc"] < n8
        cell("dfa", md, md.device_corpus(tdocs[:n8], shard=True),
             {k: v[sel] for k, v in res_dfa.items()})
        mk = Matcher(specs, ScanConfig(backend="device", engine="kgram",
                                       match_capacity=TILE_CAPACITY),
                     device=DEVICE)
        cell("kgram", mk, mk.device_corpus(tdocs, shard=True), res_tile)
        for name, length, cfg, kernel in (
            ("anchored", ANCHORED_LEN, dict(engine="cascade"), "bloom_hit"),
            ("rows", ROWS_LEN, {}, "bloom_word_vmem"),
            # the rows set on the take route: stride 5, the flat filter
            ("take-flat", ROWS_LEN, dict(bloom_impl="take"),
             "flat_take_extract"),
        ):
            mm = Matcher([{"id": i, "value": p}
                          for i, p in enumerate(needle_set(length))],
                         ScanConfig(backend="device", chunk_len=4096, **cfg),
                         device=DEVICE)
            cdocs = tdocs[:n8] if name == "anchored" else tdocs
            want = mm.match_arrays(mm.device_corpus(cdocs, shard=False))
            if name == "take-flat":
                assert mm.cascade_model.take_branch(4096) == "flat"
            cell(name, mm, mm.device_corpus(cdocs, shard=True), want, kernel)
        specs_h = [{"id": i, "value": v} for i, v in enumerate(needles)]
        mg = Matcher(specs_h, ScanConfig(backend="device", chunk_len=4096,
                                         bloom_impl="take"), device=DEVICE)
        assert mg.cascade_model.take_branch(hs.packed.row_len) == "grouped"
        cell("take-grouped", mg, hs, mg.match_arrays(h),
             "grouped_take_extract", "grouped_take_refine")
        mc = Matcher(specs_h, ScanConfig(backend="device", chunk_len=4096,
                                         table_format="compressed"),
                     device=DEVICE)
        cell("headline-compressed", mc, hds, rd)
        ms_, sdocs, res_sig, res_sdfa, n_slice = sig
        cell("signature-byte", ms_, ms_.device_corpus(sdocs, shard=True),
             res_sig, "grouped_take_extract", "grouped_take_refine")
        ms_.config = dataclasses.replace(ms_.config, engine="dfa")
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        hs8 = ms_.device_corpus(sdocs[:n_slice], shard=True)
        cell("signature-byte dfa", ms_, hs8, res_sdfa)
        ms_.config = dataclasses.replace(ms_.config, engine="auto")
        dense = ms_.model.device_arrays["dense_flat"]
        per_shard = ms_._sharded_arrays(hs8.mesh, "compressed")
        assert all(a["dense_flat"].data_ptr() == dense.data_ptr()
                   for a in per_shard)
        assert not ms_.cascade_model.__dict__.get("_replicas")
        grown = torch.cuda.memory_allocated() - before
        assert grown < dense.numel() * dense.element_size(), grown
        log(f"phase 11c: the compressed table ({dense.numel() * 4} bytes of "
            f"dense bank) is held once on the card for {SHARDS} shards: "
            f"device memory grew {grown} bytes over the sharded dfa pass "
            f"(its 8 MiB of rows and buffers included)")
        launched = launch_counts(launches0)

    # (d) the dry run; (e) two processes on the card
    log(f"phase 11d: {dryrun_multichip(SHARDS, DEVICE)}")
    phase_two_processes(torch, card, m)
    assert all(n > 0 for n in launched.values()), launched
    log(f"phase 11 hand kernel launches: {launched}")
    return launched


def run_cli(*arg_lists):
    """``python -m php_aho_corasick_tpu_torch`` once per argument list, all
    started together on the default device; returns each one's stdout and
    stderr, and fails on a non-zero exit.  No process outlives the call."""
    import os

    cmd = [sys.executable, "-m", "php_aho_corasick_tpu_torch"]
    root = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(cmd + args, cwd=root, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for args in arg_lists]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for args, p, (_, err) in zip(arg_lists, procs, outs):
        assert p.returncode == 0, f"cli {args[0]} exited {p.returncode}: {err}"
    return outs


def phase_remaining_surface(torch, card, head, planted, sig, sig_build_s):
    """Phase 12: the native builder beside the numpy one, matcher files,
    the profiling hooks, the command line and the examples on the card
    (the module docstring's item 12), every launch of the held parts held
    against its plain version.  Returns the hand kernels' launches of the
    phase."""
    import glob
    import math
    import os
    import shutil

    from php_aho_corasick_tpu_torch import Matcher, ScanConfig, native
    from php_aho_corasick_tpu_torch.examples import (
        basic, bulk_scan, serving_loop,
    )
    from php_aho_corasick_tpu_torch.utils import profiling
    from php_aho_corasick_tpu_torch.utils.serialization import (
        load_matcher, save_matcher,
    )

    needles, m, h, warm, base = head
    hd, rd = planted
    ms_, sdocs, res_sig = sig[:3]
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    # (a) the headline set by both builders
    specs = [{"id": i, "value": p} for i, p in enumerate(needles)]
    times, autos = {}, {}
    for prefer in (True, False):
        t0 = time.perf_counter()
        mb = Matcher(specs, ScanConfig(prefer_native_builder=prefer),
                     device=DEVICE)
        mb.finalize()
        times[prefer] = time.perf_counter() - t0
        autos[prefer] = mb.automaton
        assert isinstance(mb._trie, native.NativeTrieBuilder) == prefer
    nat, npy = autos[True], autos[False]
    for name in ("table", "byte_class", "emit_start", "emit_pats",
                 "pat_lens", "state_depth"):
        a, b = getattr(nat, name), getattr(npy, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert (nat.final_start, nat.max_len) == (npy.final_start, npy.max_len)
    lib = native.loaded_path()
    assert os.path.dirname(lib) == os.path.join(root, "build",
                                                "torch_kernels"), lib
    log(f"phase 12a: the headline set's tables are bit-equal from the "
        f"native and the numpy builder ({nat.n_states} states; build + "
        f"finalize {times[True]:.3f} s native, {times[False]:.3f} s numpy, "
        f"host clock); native library {os.path.relpath(lib, root)}")

    before = launch_counts()
    # (b) the 1M signature-byte matcher through a file, onto the card
    path = os.path.join(work, "signature-byte.npz")
    t0 = time.perf_counter()
    save_matcher(ms_, path)
    save_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    t0 = time.perf_counter()
    ml = load_matcher(path, ScanConfig(backend="device", chunk_len=4096),
                      device=DEVICE)
    load_s = time.perf_counter() - t0
    os.remove(path)
    assert ml.device == ms_.device and ml.table_format == "compressed"
    assert ml.automaton.n_states == ms_.automaton.n_states
    t0 = time.perf_counter()
    hl = ml.device_corpus(sdocs)
    got, _ = held_calls(lambda: ml.match_arrays_many([hl])[0],
                        "grouped_take_extract", "grouped_take_refine")
    first_s = time.perf_counter() - t0
    for key in res_sig:
        assert np.array_equal(got[key], res_sig[key]), f"loaded sig {key}"
    log(f"phase 12b: signature-byte ({ml.n_patterns} patterns, "
        f"{ml.automaton.n_states} states) saved in {save_s:.2f} s to "
        f"{size} bytes, loaded onto the card in {load_s:.2f} s (native "
        f"build {sig_build_s:.2f} s), host clock; upload, plan and first "
        f"pass over {len(sdocs)} MiB {first_s:.2f} s; "
        f"{got['doc'].shape[0]} records equal to phase 9a's; on {card}")
    del ml, hl
    path = os.path.join(work, "headline.npz")
    save_matcher(m, path)
    mh = load_matcher(path, m.config, device=DEVICE)
    assert mh.table_format == "dense"
    got, _ = held_calls(lambda: mh.match_arrays_many([hd])[0],
                        "fused_sampled_extract")
    for key in rd:
        assert np.array_equal(got[key], rd[key]), f"loaded headline {key}"
    log(f"phase 12b: the headline matcher (dense) through a file of "
        f"{os.path.getsize(path)} bytes: {got['doc'].shape[0]} records over "
        f"phase 4's planted handle, equal")
    del mh

    # (c) the profiling hooks around one headline pass
    tdir = os.path.join(work, "trace")
    with profiling.trace(tdir):
        out = m.match_arrays_many([h])[0]
    for key in warm:
        assert np.array_equal(out[key], warm[key]), f"traced pass {key}"
    files = glob.glob(os.path.join(tdir, "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        n_named = f.read().count("fused_sampled_extract")
    assert n_named > 0, "the trace does not name the fused kernel"
    chk = profiling.sync(h.lengths_d)
    assert math.isfinite(chk) and chk > 0, chk
    log(f"phase 12c: utils.profiling.trace wrote {os.path.basename(files[0])}"
        f" ({os.path.getsize(files[0])} bytes, the fused kernel named "
        f"{n_named} times); sync checksum {chk}")

    # (d) the command line in subprocesses, on its default device
    pats = probe_set()
    data = base.reshape(-1)[: 1 << 20].tobytes()
    rmap = {p: p.upper() for p in pats[::3]}
    files = {name: os.path.join(work, name) for name in (
        "pats.txt", "in.bin", "repl.tsv", "out.bin", "m.npz")}
    with open(files["pats.txt"], "wb") as f:
        f.write(b"\n".join(pats) + b"\n")
    with open(files["in.bin"], "wb") as f:
        f.write(data)
    with open(files["repl.tsv"], "wb") as f:
        f.write(b"".join(k + b"\t" + v + b"\n" for k, v in rmap.items()))
    t0 = time.perf_counter()
    (scan_out, scan_err), _, _ = run_cli(
        ["scan", "-p", files["pats.txt"], "-i", files["in.bin"]],
        ["replace", "-p", files["pats.txt"], "-r", files["repl.tsv"],
         "-i", files["in.bin"], "-o", files["out.bin"]],
        ["build", "-p", files["pats.txt"], "-o", files["m.npz"]])
    (info_out, _), = run_cli(["info", "-m", files["m.npz"]])
    cli_s = time.perf_counter() - t0
    mi = Matcher([{"id": i, "value": p} for i, p in enumerate(pats)],
                 ScanConfig(), device=DEVICE)
    recs, _ = held_calls(lambda: mi.match(data), "scan_states_tile")
    want = [json.dumps({"pos": r["pos"], "start": r["start_postion"],
                        "pattern": r["value"].decode()}) for r in recs]
    assert scan_out.splitlines() == want, "cli scan != in-process records"
    with open(files["out.bin"], "rb") as f:
        assert f.read() == mi.replace(data, rmap), "cli replace"
    assert info_out == mi.describe() == load_matcher(
        files["m.npz"], device=DEVICE).describe(), info_out
    log(f"phase 12d: the command line on the card (4 subprocesses, "
        f"{cli_s:.1f} s host clock): scan's {len(want)} records, replace's "
        f"bytes and info equal the same calls in process; the in-process "
        f"engine {mi.stats.last_engine}, the CLI's: "
        f"{scan_err.strip().splitlines()[-1]}")

    # (e) the examples at their default sizes
    t0 = time.perf_counter()
    basic.main()
    counts, _ = held_calls(bulk_scan.main, "fused_sampled_extract")
    assert len(counts) == 3 and min(counts) >= 1, counts
    recs = serving_loop.main()
    assert recs and recs[0]["keyIdx"] == 42, recs
    log(f"phase 12e: the three examples at their default sizes in "
        f"{time.perf_counter() - t0:.1f} s (bulk_scan's batches found "
        f"{counts} matches)")
    launched = launch_counts(before)
    shutil.rmtree(work)
    log(f"phase 12 hand kernel launches: {launched}")
    return launched


SOAK_SEED, SOAK_CASES = 0, 300  # phase 13: the soak's fixed slice
SOAK_TIMEOUT_S = 600
#: the slice's scans and refused routes: its draws are fixed (the seed,
#: the count and the children's hash seed), so a route that starts to
#: refuse more cases shows here
SOAK_SCANS = 229
SOAK_SKIPS = {
    "engine 'tile' requires the dense table format": 18,
    "engine 'kgram' requires the dense table format": 24,
    "tile engine forced but automaton exceeds the tile budget": 15,
    "cascade engine forced but pattern set is ineligible": 14,
}


def phase_soak(card):
    """Phase 13: a fixed slice of the randomized soak
    (``php_aho_corasick_tpu_torch/soak.py``): ``SOAK_CASES`` cases at
    ``SOAK_SEED`` in one child of the soak's parent process, each the
    public API on random needle sets, documents and configs against brute
    force, and every launch of a hand kernel against its plain version on
    the same inputs.  Fails on a mismatch, a kernel launch that differs
    from its plain version, a fault of the child, a hand kernel the cases
    never launched, or scans and skips other than the slice's; returns
    each kernel's launches over the phase and its largest difference from
    the plain version, by name."""
    import os
    import signal
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=os.path.join(root, "build")) as tmp:
        art = os.path.join(tmp, "soak.json")
        t0 = time.perf_counter()
        # its own session: on a timeout the soak's child goes too
        proc = subprocess.Popen(
            [sys.executable, "-m", "php_aho_corasick_tpu_torch.soak",
             "--seed", str(SOAK_SEED), "--total", str(SOAK_CASES),
             "--cases", str(SOAK_CASES), "--seconds", str(SOAK_TIMEOUT_S),
             "--device", DEVICE, "--artifact", art],
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, start_new_session=True)
        try:
            out = proc.communicate(timeout=SOAK_TIMEOUT_S)[0]
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        seconds = time.perf_counter() - t0
        assert proc.returncode == 0, f"soak exited {proc.returncode}:\n{out}"
        with open(art) as f:
            got = json.load(f)
    for ln in out.strip().splitlines():
        log(f"  {ln}")
    assert got["cases"] == SOAK_CASES and got["mismatches"] == 0, got
    assert (got["scans"], got["skips"]) == (SOAK_SCANS, SOAK_SKIPS), got
    launched = {k: v["launches"] for k, v in got["kernels"].items()}
    errs = {k: v["max_abs_err"] for k, v in got["kernels"].items()}
    assert set(launched) == set(launch_counts()), got["kernels"]
    assert all(n > 0 for n in launched.values()), got["kernels"]
    assert not any(errs.values()), got["kernels"]
    log(f"phase 13: soak seed {SOAK_SEED}, {got['cases']} cases, 0 "
        f"mismatches, {got['scans']} scans, skips {got['skips']}, "
        f"{seconds:.1f} s; kernels (cases, launches): "
        f"{ {k: (v['cases'], v['launches']) for k, v in got['kernels'].items()} }"
        f", each launch bit-equal to its plain version; device memory "
        f"{got['memory']}; on {card}")
    return launched, errs


#: phase 14a: the signatures tool's hex draw (1M needles of 16 hex
#: symbols, 64 MiB with 200 plants), in process
HEX_NEEDLES, HEX_MIB = 1_000_000, 64


def phase_hex_grouped(torch, card):
    """Phase 14a: the hex signature set at 1M needles in this process (the
    draw of ``bench.signatures``): the dense table and the take-grouped
    filter; one ``match_arrays`` pass over its 64 MiB counted, its
    records holding every plant, then the grouped filter's kernels held
    against their plain versions and timed at its shapes
    (:func:`grouped_check`), and the records verify's launches likewise
    (:func:`verify_check`).  Returns the pass's hand kernel launches, the
    grouped kernels' times, and the records verify's largest difference
    and times."""
    from php_aho_corasick_tpu_torch import Matcher, ScanConfig
    from php_aho_corasick_tpu_torch.bench import signatures

    t0 = time.perf_counter()
    patterns, docs, n_planted = signatures.draws("hex", HEX_NEEDLES, 16,
                                                 HEX_MIB)
    m = Matcher([{"id": i, "value": p} for i, p in enumerate(patterns)],
                ScanConfig(backend="device", chunk_len=4096), device=DEVICE)
    m.finalize()
    cm = m.cascade_model
    h = m.device_corpus(docs)
    del patterns, docs
    L = h.chunks_d.shape[1]
    assert m.table_format == "dense" and cm.bloom_impl() == "take"
    assert cm.take_branch(L) == "grouped", cm.plan.reason
    setup_s = time.perf_counter() - t0
    m.match_arrays(h)  # the adaptive capacities settle
    before = launch_counts()
    res = m.match_arrays(h)
    launched = launch_counts(before)
    launched_only(launched, "signature-hex", 1, "grouped_take_extract",
                  "grouped_take_refine", "verify_records")
    n = res["doc"].shape[0]
    assert n >= n_planted == 200, (n, n_planted)
    cap_a, _ = cm.learned_caps

    def run():
        return cm.scan_hits_sampled(h.chunks_d, h.lengths_d, cap_a)

    log(f"phase 14a: signature-hex, {m.n_patterns} needles, plan "
        f"{cm.plan.reason}, group size {cm.take_group_block_r()}, rows "
        f"{tuple(h.chunks_d.shape)}; built, planned and uploaded in "
        f"{setup_s:.1f} s (host clock); a pass {n} records ({n_planted} "
        f"planted), hand kernel launches {launched}; "
        f"device time of the grouped filter {cuda_ms(run, 5):.3f} ms; on "
        f"{card}")
    times = grouped_check(torch, card, "signature-hex", run)
    vr_hex = verify_check(torch, card, "signature-hex",
                          lambda: m.match_arrays(h))
    del m, cm, h, res
    torch.cuda.empty_cache()
    return launched, times, vr_hex


#: phase 14: the measurement tools, in the order they run, at these sizes
BENCH_RUNS = (
    # first: its native build and plan (~30 s of one host core) hide the
    # counts of bench_expected, made in a thread meanwhile
    ("signatures", ["--alphabet", "hex"]),
    ("headline", []),
    ("stage_budget", []),
    ("scaling", ["--engine", "cascade", "--devices", "4", "--mib", "32"]),
    ("reference_protocol", ["--samples", "2", "--naive-needles", "64"]),
)
BENCH_TIMEOUT_S = 300
#: each record's keys: the reference's (``BENCH_TPU_LAST.json``,
#: ``benchmarks/signature_last.json``, ``stage_budget_last.json``, the
#: words ``bench_scaling.py`` and ``benchmark_reference.py`` print), then
#: what the port adds
_PORT = {"device", "kernels"}
BENCH_KEYS = {
    "headline": ({"metric", "value", "unit", "vs_baseline", "detail"},
                 {"kernels"}),
    "stage_budget": ({"ms", "cap_a", "cap_r", "mpr", "at"},
                     {"spread", "launches", "busy"} | _PORT),
    "scaling": ({"engine", "mib", "rows"},
                {"count", "shards_of_one_card", "hash_seed"} | _PORT),
    "reference_protocol": ({"samples", "corpus_mib", "avg_naive_s",
                            "avg_ac_s", "ac_gibps", "speedup", "reference"},
                           {"matches", "hash_seed"} | _PORT),
    "signatures": ({"alphabet", "needles", "needle_len", "states",
                    "table_mib", "table_format", "build_s", "corpus_mib",
                    "gbps", "pass_ms", "matches", "planted",
                    "dfa_fallback_gbps", "engine", "measured_at"},
                   {"plan_s", "hash_seed"} | _PORT),
}
HEADLINE_DETAIL_KEYS = (
    {"corpus_mib", "pass_ms", "pass_ms_spread", "public_api",
     "caps_moved_during_timing", "e2e_gbps_via_relay", "cold_path",
     "build_s", "engine", "states", "matches", "match_density_gbps",
     "signature_scale", "device"},
    {"e2e_path"},
)


def run_tool(name, args, art):
    """``python -m php_aho_corasick_tpu_torch.bench.<name> args`` in its
    own session (killed on a timeout); returns its record (the artifact,
    equal to its last line) and its seconds."""
    import os
    import signal

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", f"php_aho_corasick_tpu_torch.bench.{name}",
         *args, "--device", DEVICE, "--artifact", art],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)
    try:
        out = proc.communicate(timeout=BENCH_TIMEOUT_S)[0]
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert proc.returncode == 0, f"{name} exited {proc.returncode}:\n{out}"
    with open(art) as f:
        rec = json.load(f)
    assert json.loads(out.strip().splitlines()[-1]) == rec, name
    return rec, time.perf_counter() - t0


def window_count(needles, haystacks):
    """Occurrences of distinct equal-length ``needles`` in ``haystacks``:
    every window looked up in a set."""
    want = set(needles)
    n = len(next(iter(want)))
    return sum(h[i : i + n] in want
               for h in haystacks for i in range(len(h) - n + 1))


def bench_expected(auto, needles, base):
    """What phase 14's records must say, counted here without the tools'
    scans: each headline density row's records by :func:`host_walk` over
    its planted corpus (``bench.headline.planted`` at half the headline's
    corpus), with its plants still whole; and the PHP protocol's matches
    a sample by :func:`window_count` over the tool's draws."""
    from php_aho_corasick_tpu_torch.bench import headline, reference_protocol

    dens = {}
    dens_docs = headline.corpus(base, (headline.MIB << 20) // 2)
    for d in headline.DENSITIES:
        docs, plants = headline.planted(dens_docs, needles, d)
        arr = np.frombuffer(b"".join(docs), np.uint8).reshape(len(docs), -1)
        dens[f"{d:g}"] = (host_walk(auto, arr).shape[1],
                          headline.surviving(docs, plants))
    samples = int(dict(BENCH_RUNS)["reference_protocol"][1])
    rng = random.Random(reference_protocol.SEED)
    protocol = [window_count(*reference_protocol.draw_sample(
        rng, 2048, 16, 256, 8192)) for _ in range(samples)]
    return {"density": dens, "protocol": protocol}


def check_tool(name, rec, expected):
    """Phase 14's checks of one tool's record beyond its keys."""
    if name == "headline":
        d = rec["detail"]
        assert d["matches"] == 0, d
        assert set(d) == set.union(*HEADLINE_DETAIL_KEYS), sorted(d)
        rows = d["match_density_gbps"]
        assert set(rows) == set(expected["density"]), rows
        for key, (walked, whole) in expected["density"].items():
            # later plants overwrite earlier ones; every whole one is found
            assert rows[key]["matches"] == walked >= whole > 0, (
                key, rows[key], walked, whole)
    elif name == "stage_budget":
        # records and public do the same dispatch-bound chains: a row is
        # within the pass when its fastest run is no slower than the
        # public row's slowest
        pub = rec["spread"]["public"][1]
        assert all(v > 0 for v in rec["ms"].values()), rec["ms"]
        assert all(lo <= pub for lo, _ in rec["spread"].values()), rec
    elif name == "signatures":
        # the dense hex table at 1M needles plans the take-grouped filter
        assert rec["planted"] == 200 <= rec["matches"], rec
        assert rec["table_format"] == "dense", rec
        assert all(rec["kernels"][n]["launches"] > 0 for n in (
            "grouped_take_extract", "grouped_take_refine")), rec["kernels"]
    elif name == "scaling":
        assert rec["shards_of_one_card"] and rec["count"] > 0, rec
        assert [r["devices"] for r in rec["rows"]] == [1, 2, 4], rec
    elif name == "reference_protocol":
        got = [r["matches"] for r in rec["samples"]]
        assert got == expected["protocol"], (got, expected["protocol"])
        assert rec["matches"] == sum(got), rec


def phase_bench(card, auto, needles, base):
    """Phase 14: the five measurement tools (``BENCH_RUNS``) in
    subprocesses; each runs its workload once with every kernel launch
    held to the plain version before it times anything.  Fails on a tool
    that exits non-zero, a record without the reference's keys, a miss of
    :func:`check_tool` against :func:`bench_expected` (counted in a
    thread while the tools run), or a held launch that differs from its
    plain version.  Returns each kernel's launches over the tools' runs
    and its largest difference, by name."""
    import os
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    launched = dict.fromkeys(launch_counts(), 0)
    errs = dict(launched)
    root = os.path.dirname(os.path.abspath(__file__))
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.join(root, "build")) as tmp, \
            ThreadPoolExecutor(1) as pool:
        pending = pool.submit(bench_expected, auto, needles, base)
        for name, args in BENCH_RUNS:
            rec, seconds = run_tool(name, args,
                                    os.path.join(tmp, f"{name}.json"))
            ref_keys, port_keys = BENCH_KEYS[name]
            assert set(rec) == ref_keys | port_keys, (name, sorted(rec))
            check_tool(name, rec, pending.result())
            k = rec["kernels"]
            assert set(k) == set(launched), (name, k)
            for n in k:
                launched[n] += k[n]["launches"]
                errs[n] = max(errs[n], k[n]["max_abs_err"])
            assert not any(errs.values()), (name, k)
            log(f"phase 14: {name} {' '.join(args)} in {seconds:.1f} s: "
                f"{json.dumps(rec)}")
    expected = pending.result()
    assert min(launched["fused_sampled_extract"],
               launched["grouped_take_extract"],
               launched["grouped_take_refine"]) > 0, launched
    log(f"phase 14: 5 tools in {time.perf_counter() - t_all:.1f} s, every "
        f"held launch bit-equal to its plain version; density rows' records "
        f"equal the host walk's {expected['density']} (records, plants "
        f"whole), the protocol's matches a sample the window count's "
        f"{expected['protocol']}; hand kernel launches: {launched}; on "
        f"{card}")
    return launched, errs


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--parent", metavar="CSRC",
        help="the csrc directory of another checkout: its bloom_word_vmem "
             "is built and timed beside this tree's at the rows cell")
    ap.add_argument(
        "--worker", nargs=4, metavar=("HOST:PORT", "RANK", "DEVICE", "REPS"),
        help="run one of phase 11e's two ranks (the script starts them)")
    opts = ap.parse_args(argv)
    parent = opts.parent
    import os

    # bytecode of each module imported from here on (torch's too) is
    # written under build/, even where the environment turns bytecode
    # writes off, so that the phases' subprocesses (CLI, soak, tools,
    # workers) load it instead of compiling torch again in every process
    sys.pycache_prefix = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build", "pycache")
    sys.dont_write_bytecode = False
    os.environ["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    import torch

    if opts.worker:
        addr, rank, device, reps = opts.worker
        return two_process_worker(addr, int(rank), device, int(reps))

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from php_aho_corasick_tpu_torch import Matcher, ScanConfig
    from php_aho_corasick_tpu_torch.ops import _build
    from php_aho_corasick_tpu_torch.ops.filter_cuda import (
        bloom_hit as bh,
        bloom_word_vmem as bwv,
        fused_launch_shape,
        fused_sampled_extract as fse,
        grouped_take_extract as gte,
        grouped_take_refine as gtr,
        verify_records as vr,
    )
    from php_aho_corasick_tpu_torch.ops.scan_cuda import (
        scan_states_tile as sst,
    )

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")

    # 1. build
    t0 = time.perf_counter()
    report = _build.build_all(ptxas_info=True)
    log(f"build: {time.perf_counter() - t0:.2f} s for {len(report)} "
        f"kernel(s); card: {card}")
    for name, r in report.items():
        log(f"  {name}: {r['seconds']:.2f} s; {ptxas_lines(report, name)}")

    # 2a. kernel vs plain: random tables, shorts, pack=1
    n_hits, err1 = phase_kernel_random(torch, fse)
    log(f"kernel check 1 (random tables, shorts, pack=1): bit-equal, "
        f"{n_hits} hits")
    n_fc, err_fc = phase_fused_cases(torch, fse)
    log(f"kernel check 1b (fused, {n_fc} cases: spc 1-4 x pack 1/2/4 x q "
        f"1/9/16, prefix on/off, tables over the shared budget): "
        f"bit-equal")
    n_cases, tile_err = phase_tile_random(torch, sst)
    log(f"kernel check 3 (scan_states_tile, {n_cases} random tables): "
        f"bit-equal")
    n_sync, sync_err = phase_tile_sync(torch, sst)
    log(f"kernel check 3b (scan_states_tile with sync_len, {n_sync} "
        f"Aho-Corasick tables): bit-equal")
    n_vmem, vmem_err, n_hit, hit_err = phase_bloom_random(torch, bwv, bh)
    log(f"kernel check 4 (bloom_word_vmem, {n_vmem} random tables; "
        f"bloom_hit, {n_hit} random blooms): bit-equal")
    n_gr, gr_err = phase_grouped_random(torch, gte, gtr)
    log(f"kernel check 5 (grouped_take_extract and grouped_take_refine, "
        f"{n_gr} random cases: strides 4-32, q 1-16, 1-8 salts, the second "
        f"code family, shorts, min_long_len 0, prefix off and on): "
        f"bit-equal")
    n_vr, vr_err = phase_verify_random(torch, vr)
    log(f"kernel check 6 (verify_records, {n_vr} random calls: 4-48 used "
        f"bytes, int16 / int32 / 2-step tables, strides 3-12, n_hits past "
        f"the hits, all padding, capacities under the record count): "
        f"bit-equal")

    # 3. main path setup at the headline size
    needles, base = workload()
    cfg = ScanConfig(backend="device", chunk_len=4096)
    t0 = time.perf_counter()
    m = Matcher([{"id": i, "value": p} for i, p in enumerate(needles)], cfg,
                device=DEVICE)
    m.finalize()
    cm = m.cascade_model
    log(f"matcher: {time.perf_counter() - t0:.2f} s build, plan "
        f"{cm.plan.reason}, states {m.automaton.n_states}, "
        f"records2 {cm.records2_ok}")
    docs = [row.tobytes() for row in base] * HEADLINE_REPS
    total = sum(map(len, docs))
    t0 = time.perf_counter()
    h = m.device_corpus(docs)
    torch.cuda.synchronize()
    log(f"device_corpus: {total / 2**20:.0f} MiB in "
        f"{time.perf_counter() - t0:.2f} s, rows {tuple(h.chunks_d.shape)}")
    warm = m.match_arrays(h)
    log(f"warm-up match_arrays: {warm['doc'].shape[0]} matches")

    # 2b. kernel vs plain: headline plan tables at the headline shape
    args, kw = extract_args(cm, h)
    got = fse(*args, **kw)
    want = fse.plain(*args, **kw)
    torch.cuda.synchronize()
    err2 = compare(got, want, "headline plan, prefix refine")
    n_blocks = got[4].shape[0]
    log(f"kernel check 2 (headline plan, mpr {kw['mpr']}, {n_blocks} "
        f"blocks, prefix refine): bit-equal, {int(got[4].sum())} hits")
    k_ms = cuda_ms(lambda: fse(*args, **kw), 50)
    p_ms = cuda_ms(lambda: fse.plain(*args, **kw), 3)
    b_ms, b_by, b_bytes, b_ops = in_ms(fused_bound(args, kw, got))
    log(f"fused_sampled_extract at the headline shape: {k_ms:.4f} ms "
        f"({100 * b_ms / k_ms:.1f}% of bound; plain {p_ms:.3f} ms, bound "
        f"{b_ms:.4f} ms by {b_by}: {b_bytes} bytes, {b_ops} ops) on {card}")
    # where its time goes: no long codes at all (mll = 0: staging, the
    # rank scan and the slot fill), and a zero table (every code dies in
    # the first probes: the 4 unconditional ones, no queue)
    table, phases, _, mll = args
    no_codes = (table, phases, None, torch.zeros_like(mll))
    one_probe = (torch.zeros_like(table), phases, None, mll)
    a_ms = [cuda_ms(lambda: fse(*a, **kw), 50) for a in (no_codes, one_probe)]
    log(f"fused_sampled_extract parts: {a_ms[0]:.4f} ms with no long codes "
        f"(mll = 0), {a_ms[1]:.4f} ms with a zero table (code assembly and "
        f"the first probes, nothing queued), {k_ms:.4f} ms with the plan's "
        f"table, on {card}")
    table_bytes = 4 * (args[0].numel() + kw["prefix_table"].numel())
    shape = fused_launch_shape(kw["q"], table_bytes, n_blocks)
    log(f"fused_sampled_extract launch: {shape}, {table_bytes} bytes of "
        f"tables; {ptxas_lines(report, 'fused_sampled_extract')}")

    # the main path, counted and timed
    m.match_arrays_many([h] * BATCH)  # warm the batch structure
    torch.cuda.synchronize()
    fse.launches = 0
    vr.launches = 0
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    w0 = time.perf_counter()
    e0.record()
    res = m.match_arrays_many([h] * BATCH)
    e1.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - w0) / BATCH
    launches = fse.launches
    ms = e0.elapsed_time(e1) / BATCH
    assert launches >= BATCH, f"fused kernel launched {launches} times"
    # one records verify a chain, never the torch loop
    assert vr.launches == launches, (vr.launches, launches)
    assert all(r["doc"].shape == res[0]["doc"].shape for r in res)
    for key in res[0]:
        assert np.array_equal(res[0][key], warm[key]), key
    log(f"main path: match_arrays_many([handle] * {BATCH}) over "
        f"{total / 2**20:.0f} MiB: {ms:.3f} ms/pass by CUDA events "
        f"({wall * 1e3:.3f} ms wall), {total / ms / 1e6:.2f} GB/s, "
        f"{res[0]['doc'].shape[0]} matches/pass, kernel launches "
        f"{launches} (verify_records {vr.launches}), on {card}")
    vr_launches = vr.launches
    err_h, vr_times = verify_check(torch, card, "headline",
                                   lambda: m.match_arrays(h))

    trace_breakdown(torch, lambda n: m.match_arrays_many([h] * n), card)

    # the dispatch half must not synchronise with the host
    pending = assert_no_sync(
        torch, lambda: m._records_batch_dispatch([h] * 2, cm))
    m._records_batch_finish(*pending, True)
    log("sync check (set_sync_debug_mode='error'): no host sync in the "
        "records dispatch")

    # 4. planted matches against a host DFA walk
    hd, rd = planted_check(m, needles, base, int(DENSITY * 1e9),
                           "planted corpus")
    err_p, vr_planted = verify_check(torch, card, "planted",
                                     lambda: m.match_arrays(hd))

    # 5. the tile path
    tile_cell, tile_kernel = phase_tile_path(
        torch, base, card, sst, ptxas_lines(report, "scan_states_tile"))
    tile_kernel["max_abs_err"] = max(tile_kernel["max_abs_err"], tile_err,
                                     sync_err)

    # 6. the rows path, 7. the anchored path
    rows_kernel = phase_rows_path(torch, base, card, bwv,
                                  ptxas_lines(report, "bloom_word_vmem"),
                                  parent)
    rows_kernel["max_abs_err"] = max(rows_kernel["max_abs_err"], vmem_err)
    hit_kernel = phase_anchored_path(torch, base, card, bh)
    hit_kernel["max_abs_err"] = max(hit_kernel["max_abs_err"], hit_err)

    # 8. the take filters: the grouped one on its two kernels
    take_launched, take_times, vr_shapes, flat = phase_take_path(
        torch, base, card, (needles, h, warm))
    fused_kernel = {
        "name": "fused_sampled_extract",
        "route": "cuda",
        "source": "php_aho_corasick_tpu_torch/csrc/fused_sampled_extract.cu",
        "replaces": "php_aho_corasick_tpu/ops/filter_pallas.py:765",
        "launches": launches,
        "max_abs_err": max(err1, err_fc, err2),
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    }
    grouped = {}
    for name, line in (("grouped_take_extract", 468),
                       ("grouped_take_refine", 534)):
        grouped[name] = {
            "name": name,
            "route": "cuda",
            "source": f"php_aho_corasick_tpu_torch/csrc/{name}.cu",
            # XLA code of the reference, not a Pallas kernel: stages A and
            # B1, and stage B2 with its bloom_hit_take bit test
            "replaces": f"php_aho_corasick_tpu/ops/filter_jax.py:{line}",
            "launches": 0,
            "max_abs_err": gr_err,
            **take_times[name],  # at the take-grouped cell's shapes
            "library_ms": None,
        }
    vr_err = max([vr_err, err_h, err_p]
                 + [e for e, _ in vr_shapes.values()])
    verify_kernel = {
        "name": "verify_records",
        "route": "cuda",
        "source": "php_aho_corasick_tpu_torch/csrc/verify_records.cu",
        # XLA code of the reference: the records verify's walk and
        # compaction
        "replaces": "php_aho_corasick_tpu/ops/filter_jax.py:1023",
        "launches": vr_launches,
        "max_abs_err": vr_err,
        **next(iter(vr_times.values())),  # at the headline's shape
        "library_ms": None,
    }
    flat_kernel = {
        "name": "flat_take_extract",
        "route": "cuda",
        "source": "php_aho_corasick_tpu_torch/csrc/flat_take_extract.cu",
        # XLA code of the reference: the flat take filter's codes, probes
        # and compaction
        "replaces": "php_aho_corasick_tpu/ops/filter_jax.py:214",
        "launches": 0,
        "max_abs_err": 0,  # every launch held: a difference raises
        **flat["take-flat"],  # at the take-flat cell's shapes
        "library_ms": None,
    }
    kernels = [fused_kernel, tile_kernel, rows_kernel, hit_kernel,
               *grouped.values(), verify_kernel, flat_kernel]
    lines = {k["name"]: k for k in kernels}
    assert set(lines) == set(launch_counts()), sorted(lines)

    def count(launched, errs=None):
        """A phase's launches and largest differences by kernel name,
        added to the kernel lines."""
        for name, k in lines.items():
            k["launches"] += launched[name]
            k["max_abs_err"] = max(k["max_abs_err"],
                                   (errs or {}).get(name, 0))

    count(take_launched)

    # 9. the compressed table, the flagged-window verify, the k-gram engine
    sig_launched, sig_times, sig, sig_build_s = phase_signature_path(
        torch, card)
    comp_launched, comp_err = phase_compressed_path(
        torch, card, (needles, m, hd, rd))
    kgram_launched = phase_kgram_path(torch, card, tile_cell)
    count(sig_launched)
    count(comp_launched, {"fused_sampled_extract": comp_err})
    count(kgram_launched)

    # 10. serving and streaming: the fresh-corpus pipeline, the cross-batch
    # double buffer, the stream's two carries, iter_matches, replace, warmup
    serve_launched, serve_err = phase_serving_path(
        torch, card, (needles, m, h, hd, rd), tile_cell, base)
    count(serve_launched, {"fused_sampled_extract": serve_err})

    # 11. the data mesh: 4 shards of the card
    count(phase_shard_path(torch, card, (needles, m, h, warm), (hd, rd),
                           tile_cell, sig, base))

    # 12. the native builder, matcher files, profiling, the CLI, examples
    count(phase_remaining_surface(torch, card, (needles, m, h, warm, base),
                                  (hd, rd), sig, sig_build_s))

    # 13. the randomized soak's fixed slice, in a subprocess
    count(*phase_soak(card))

    # 14. the hex signature set's grouped filter in process, then the
    # measurement tools in subprocesses
    del sig
    hex_launched, hex_times, vr_shapes["signature-hex"] = (
        phase_hex_grouped(torch, card))
    count(hex_launched, {"verify_records": vr_shapes["signature-hex"][0]})
    count(*phase_bench(card, m.automaton, needles,
                       [row.tobytes() for row in base]))
    for name in grouped:
        log(f"{name} at three shapes, ms (plain, bound): " + "; ".join(
            f"{what} {t[name]['ms']:.4f} ({t[name]['plain_ms']:.4f}, "
            f"{t[name]['bound_ms']:.6f} by {t[name]['bound_by']})"
            for what, t in (("take-grouped", take_times),
                            ("signature-byte", sig_times),
                            ("signature-hex", hex_times)))
            + f"; on {card}")

    # 15. timings and the last line
    log("flat_take_extract at two shapes, ms (plain, bound): " + "; ".join(
        f"{what} {t['ms']:.4f} ({t['plain_ms']:.4f}, {t['bound_ms']:.6f} by "
        f"{t['bound_by']})" for what, t in flat.items())
        + f"; on {card}")
    vr_shapes = {"headline": (err_h, vr_times),
                 "planted": (err_p, vr_planted), **vr_shapes}
    log("verify_records by shape and capacity, ms (plain, bytes floor): "
        + "; ".join(f"{what} {cap}: {t['ms']:.4f} ({t['plain_ms']:.4f}, "
                    f"{t['bound_ms']:.6f})"
                    for what, (_, times) in vr_shapes.items()
                    for cap, t in times.items()) + f"; on {card}")
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
