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
   needles at 64 MiB;
   take-grouped, the headline set with ``bloom_impl="take"`` on the
   headline's handle, timed with its ``bloom_hit`` launches counted (the
   prefix refinement), equal to the fused route, the kernel against
   ``bloom_hit_take`` at the shapes this path gives it, planted needles;
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
   through ``CompressedAutomaton.lookup``;
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
   rows, take-grouped, headline-compressed and signature-byte cells, each
   equal to its unsharded records, the compressed table held once on the
   card; (d) ``parallel.dryrun.dryrun_multichip(4, "cuda")``; (e) two
   processes on the card (``torch.distributed`` with gloo, both ranks on
   ``cuda:0``, the script run again with ``--worker``) over 16 MiB with
   needles planted at 1e-5, both equal to the single-process records.  Each kernel's first launch of the phase, at a
   shard's shape, is held against its plain version;
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
   process; (e) the three examples at their default sizes.  The kernels
   each part launches are held against their plain versions at its shapes
   (the tile kernel of (d) in process, the fused kernel of (e), the
   loaded matcher's ``bloom_hit`` in (b));
13. one JSON line of kernel timings, the card's name and power limit, and
   the last line ``{"ok": true, "device": {...}}``.

Phases 9c and 11c run on the 1M-needle matcher of 9a too.

Phase 2 also holds ``bloom_word_vmem`` (pack 1/2/4, k 1-8, 2^12-2^15-word
tables, some over the shared-memory budget, ragged code counts down to 1,
code views 1-3 elements past a 16-byte boundary, tables of zeros and of
ones) and ``bloom_hit`` (blooms of 2^15-2^20 bits) against their plain
versions.
"""

import json
import random
import subprocess
import sys
import time

import numpy as np

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
FORCE_TAKE_NEEDLE, FORCE_TAKE_REPS = b"abcdefabcdefabcd", 70000
# bench_signatures.py --alphabet byte at its full 1M needles
SIG_NEEDLES, SIG_LEN, SIG_MIB, SIG_DOC = 1_000_000, 16, 64, 1 << 20
KGRAM_PASSES = 3
# phase 10: fresh-corpus passes, stream batches, feed sizes, warmup shape
FRESH_PASSES, STREAM_BATCHES = 3, 6
STREAM_FEED, CARRY_FEED, CARRY_BYTES = 4 << 20, 1 << 20, 8 << 20
WARMUP_DOC, WARMUP_DOCS = 1 << 20, 16
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# The four kernels do 32-bit integer work, one instruction per counted
# operation.  The H100 SXM runs int32 operations on 64 lanes per SM (half
# its 128 fp32 lanes; NVIDIA Hopper architecture white paper): 132 SMs x 64
# lanes x 1.98 GHz boost clock.
INT32_OPS_PER_S = 132 * 64 * 1.98e9


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
    """Max abs difference of the kernel's outputs from the plain
    version's; raises unless they are equal bit for bit."""
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
    them for this corpus handle (ops/filter_torch.filter_hits_sampled_vmem)."""
    from php_aho_corasick_tpu_torch.ops.filter_torch import FUSED_BLOCK_R

    p = cm.plan
    dev = cm.device_arrays
    B, L = dc.chunks_d.shape
    n_grid = B * (L // p.stride)
    pb_rows = (1 << p.prefix_log2) // 32 // 128
    mpr = min(128, max(8, -(-cm._cap_coarse // 8) * 8))
    args = (dev["vmem_table"], dc.fused_phases(cm), None,
            dev["min_long_len"].reshape(1, 1))
    kw = dict(
        salts=p.vmem_salts, log2_rows=p.vmem_log2_rows, pack=p.vmem_pack,
        q=p.q, spc=p.stride // 4, mpr=mpr, block_r=FUSED_BLOCK_R,
        n_grid=n_grid, l16=p.prefix_len, prefix_on=True,
        prefix_table=dev["prefix_words"].reshape(pb_rows, 128),
        prefix_salts=p.prefix_salts, prefix_log2=p.prefix_log2,
    )
    return args, kw


def plain(args, kw):
    from php_aho_corasick_tpu_torch.ops.filter_cuda import (
        _fused_extract_torch,
    )

    table, phase_g, sw_g, mll = args
    n_blocks = (phase_g.shape[1] - 8) // kw["block_r"]
    return _fused_extract_torch(
        table, phase_g, sw_g, mll, kw["salts"], kw["log2_rows"], kw["pack"],
        kw["q"], kw["spc"], kw["mpr"], kw["block_r"], n_blocks,
        kw["n_grid"], kw["l16"], kw["prefix_on"],
        prefix_table=kw["prefix_table"], prefix_salts=kw["prefix_salts"],
        prefix_log2=kw["prefix_log2"],
    )


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


def bound_of(n_bytes, ops):
    """The larger of the memory and the operations floor, in ms."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", n_bytes, ops)


def assert_no_sync(torch, fn):
    """Run ``fn`` under ``set_sync_debug_mode("error")``: any host
    synchronisation raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def bound_ms(args, kw, out):
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


def phase_kernel_random(torch, fse, plain_fn):
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
    want = plain_fn(args, kw)
    torch.cuda.synchronize()
    err = compare(got, want, "random tables, shorts, pack=1")
    return int(got[4].sum().item()), err


def phase_fused_cases(torch, fse, plain_fn):
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
        want = plain_fn(args, kw)
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
    b_ms, b_by, b_bytes, b_ops = bound_of(
        codes.numel() * 8 + table.numel() * 4,
        12 * salt_probes(table, u32(codes), *kargs))
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
    b_ms, b_by, b_bytes, b_ops = bound_of(
        slots.numel() * 8 + words.numel() * 4, 5 * slots.numel())
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


def counts_zeroed(kernels):
    for k in kernels:
        k.launches = 0


def spy_bloom_hit(fn):
    """Run ``fn()`` with ``ops/filter_cuda.bloom_hit`` wrapped so that the
    ``(words, slots)`` of every call are kept; returns them."""
    from php_aho_corasick_tpu_torch.ops import filter_cuda

    real, seen = filter_cuda.bloom_hit, []

    def spy(words, slots):
        seen.append((words, slots))
        return real(words, slots)

    # the wrapper counts its launches on the module's ``bloom_hit``
    spy.launches = real.launches
    filter_cuda.bloom_hit = spy
    try:
        fn()
    finally:
        filter_cuda.bloom_hit = real
        real.launches = spy.launches
    return seen


def phase_take_path(torch, base, card, head, kernels):
    """The sampled take filters (no hand kernel of their own; the grouped
    one's prefix refinement probes through ``bloom_hit``): take-flat at
    16,384 needles, take-grouped on the headline's handle, force-take.
    ``head`` is the headline's ``(needles, handle, warm result)``.
    Returns the ``bloom_hit`` launches of the grouped run and the
    kernel's largest difference from ``bloom_hit_take`` at its shapes."""
    from php_aho_corasick_tpu_torch import Matcher, ScanConfig
    from php_aho_corasick_tpu_torch.ops.filter_torch import bloom_hit_take

    fse, bwv, bh, sst = kernels
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
    counts_zeroed(kernels)
    ms, res, wall = timed_passes(
        torch, lambda: m.match_arrays_many([h] * BATCH), 1)
    ms, wall = ms / BATCH, wall / BATCH
    launched = [k.launches for k in kernels]
    assert m.stats.records_fallbacks == fallbacks, "batch fell back"
    assert not any(launched), f"take-flat launched hand kernels: {launched}"
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
        f"{res[0]['doc'].shape[0]} matches/pass, no hand kernel launched, "
        f"no records fallback, no host verify; device time of the flat "
        f"filter {f_ms:.3f} ms, of filter + record verify {c_ms:.3f} ms "
        f"(capacity {max(cm._cap_hits, 256)}); on {card}")
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
    counts_zeroed(kernels)
    ms, res, wall = timed_passes(
        torch, lambda: mg.match_arrays_many([hh] * BATCH), 1)
    ms, wall = ms / BATCH, wall / BATCH
    hit_launches = bh.launches
    others = [k.launches for k in (fse, bwv, sst)]
    assert hit_launches >= BATCH, f"bloom_hit launched {hit_launches} times"
    assert not any(others), f"take-grouped launched other kernels: {others}"
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
        f"(equal to the fused route), bloom_hit launches {hit_launches}, "
        f"group size {cg.take_group_block_r()}, slot capacity "
        f"{cg._cap_coarse}; device time of the grouped filter {f_ms:.3f} "
        f"ms; on {card}")
    trace_breakdown(torch, lambda n: mg.match_arrays_many([hh] * n), card)
    pending = assert_no_sync(
        torch, lambda: mg._records_batch_dispatch([hh] * 2, cg))
    mg._records_batch_finish(*pending, True)
    log("sync check (set_sync_debug_mode='error'): no host sync in the "
        "take-grouped dispatch")
    # the kernel at the shapes this path gives it: the prefix bit test of
    # the compacted hits, one call a prefix salt
    seen = spy_bloom_hit(lambda: cg.scan_hits_sampled(
        hh.chunks_d, hh.lengths_d, cap))
    assert len(seen) == len(cg.plan.prefix_salts), len(seen)
    err = 0
    for words, slots in seen:
        got = bh(words, slots)
        want = bloom_hit_take(words, slots)
        torch.cuda.synchronize()
        err = max(err, compare([got], [want],
                               f"bloom_hit, take-grouped, {slots.numel()} "
                               f"slots"))
    words, slots = seen[0]
    k_ms = cuda_ms(lambda: bh(words, slots), 50)
    p_ms = cuda_ms(lambda: bloom_hit_take(words, slots), 50)
    log(f"bloom_hit at the take-grouped shape ({slots.numel()} slots, "
        f"{words.numel()} words): bit-equal to bloom_hit_take; {k_ms:.4f} ms "
        f"(plain {p_ms:.4f} ms); on {card}")
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
    return hit_launches, err


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


def phase_tile_random(torch, sst, plain_fn):
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
        want = plain_fn(*args, lt)
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


def phase_tile_sync(torch, sst, plain_fn):
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
        want = plain_fn(*args, c(lengths))
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


def tile_bound_ms(table, chunks, n_classes):
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


def phase_tile_path(torch, base, card, sst, plain_fn, ptxas):
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
    want = plain_fn(*args, h.lengths_d)
    torch.cuda.synchronize()
    err = compare(got, want, "tile kernel, probe table, 32 MiB, sync_len")
    err = max(err, compare(sst(*args, lengths=h.lengths_d), want,
                           "tile kernel, probe table, 32 MiB, whole rows"))
    k_ms = cuda_ms(lambda: sst(*args, lengths=h.lengths_d, sync_len=sync),
                   20)
    w_ms = cuda_ms(lambda: sst(*args, lengths=h.lengths_d), 20)
    p_ms = cuda_ms(lambda: plain_fn(*args, h.lengths_d), 3)
    shape = tile_launch_shape(dev["table_flat"].numel(), B, L, sync)
    b_ms, b_by, b_bytes, b_ops = tile_bound_ms(dev["table_flat"], h.chunks_d,
                                              auto.n_classes)
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


def launched_of(kernels):
    return [k.launches for k in kernels]


def phase_signature_path(torch, card, kernels):
    """Phase 9a and 9c: the 1M-needle byte signature set, whose dense
    table would exceed ``dense_table_max_bytes``, at the default config:
    the native builder's compressed table, the sampled cascade over 64 MiB
    (``match_arrays_many`` timed, counted, traced, sync-checked), every
    planted needle found, 8 MiB equal to a host walk through
    ``CompressedAutomaton.lookup``, ``bloom_hit`` against its plain version
    at the shapes the path gives it; then ``engine="dfa"`` (the compressed
    walk) over those 8 MiB, equal.  Returns the hand kernels' launches of
    the timed batch, ``bloom_hit``'s largest difference from its plain
    version, the matcher with its documents and records, and the build
    seconds."""
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
    counts_zeroed(kernels)
    ms, res, wall = timed_passes(
        torch, lambda: m.match_arrays_many([h] * BATCH), 1)
    ms, wall = ms / BATCH, wall / BATCH
    launched = launched_of(kernels)
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
        f"matches/pass; hand kernel launches (fused, bloom_word_vmem, "
        f"bloom_hit, tile) {launched}; device time of the filter "
        f"{f_ms:.3f} ms, of filter + record verify {c_ms:.3f} ms (capacity "
        f"{cap_a}); peak device memory {peak} bytes; on {card}")
    trace_breakdown(torch, lambda n: m.match_arrays_many([h] * n), card,
                    passes=1)
    # bloom_hit at the shapes this path gives it (the prefix probe of the
    # grouped filter's slots), against its plain version
    from php_aho_corasick_tpu_torch.ops.filter_torch import bloom_hit_take

    bh = kernels[2]
    seen = spy_bloom_hit(lambda: cm.scan_hits_sampled(
        h.chunks_d, h.lengths_d, cap_a))
    assert len(seen) == len(p.prefix_salts), len(seen)
    err = 0
    for words, slots in seen:
        got = bh(words, slots)
        want = bloom_hit_take(words, slots)
        torch.cuda.synchronize()
        err = max(err, compare([got], [want], f"bloom_hit, signature-byte, "
                                              f"{slots.numel()} slots"))
    words, slots = seen[0]
    k_ms = cuda_ms(lambda: bh(words, slots), 50)
    p_ms = cuda_ms(lambda: bloom_hit_take(words, slots), 50)
    log(f"bloom_hit at the signature-byte shape ({slots.numel()} slots, "
        f"{words.numel()} words): bit-equal to bloom_hit_take; {k_ms:.4f} ms "
        f"(plain {p_ms:.4f} ms); on {card}")
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
    counts_zeroed(kernels)
    d_ms, rdfa, d_wall = timed_passes(torch, lambda: m.match_arrays(h8), 1)
    d_launched = launched_of(kernels)
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
    return launched, err, (m, docs, res[0], rdfa, n_slice), build_s


def phase_compressed_path(torch, card, kernels, head):
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
    counts_zeroed(kernels)
    ms, res, wall = timed_passes(
        torch, lambda: mc.match_arrays_many([hd] * BATCH), 1)
    ms, wall = ms / BATCH, wall / BATCH
    launched = launched_of(kernels)
    assert launched[0] >= BATCH, f"fused kernel launched {launched[0]} times"
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
    fse = kernels[0]
    args, kw = extract_args(cc, hd)
    got, want = fse(*args, **kw), plain(args, kw)
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


def phase_kgram_path(torch, card, kernels, tile_cell):
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
    counts_zeroed(kernels)
    ms, res, wall = timed_passes(torch, lambda: mk.match_arrays(h),
                                 KGRAM_PASSES)
    launched = launched_of(kernels)
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


def phase_serving_path(torch, card, kernels, head, tile_cell, base):
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
    counts_zeroed(kernels)

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
    launched = launched_of(kernels)
    assert launched[0] > 0, f"fused kernel launched {launched[0]} times"
    log(f"phase 10 hand kernel launches (fused, rows, bloom_hit, tile): "
        f"{launched}")

    # the fused kernel at a fresh slice's shape, against its plain version
    fse = kernels[0]
    hs = m.device_corpus(docs[: cfg.fresh_slice_bytes // DOC_BYTES])
    args, kw = extract_args(cm, hs)
    got, want = fse(*args, **kw), plain(args, kw)
    torch.cuda.synchronize()
    err = compare(got, want, "fused, a fresh slice")
    log(f"fused_sampled_extract at a fresh slice's shape (rows "
        f"{tuple(hs.chunks_d.shape)}): bit-equal to its plain version")
    return launched, err


SHARDS = 4  # phase 11: shards of the one card
TWO_PROC_REPS, TWO_PROC_SHARDS = 8, 2  # 16 MiB of planted docs; shards a rank


def spy_first(module, name, fn, also=()):
    """Run ``fn()`` with the kernel wrapper ``module.name`` wrapped so that
    its first call is kept: returns ``fn()``'s result and that call's
    ``(args, kwargs, output)``.  The wrapper still counts its launches.
    ``also``: modules that imported the wrapper by name, wrapped too."""
    real, seen = getattr(module, name), []

    def spy(*args, **kw):
        out = real(*args, **kw)
        if not seen:
            seen.append((args, kw, out))
        return out

    # the wrappers count their launches on the module's name
    spy.launches = real.launches
    if hasattr(real, "segmented_launches"):
        spy.segmented_launches = real.segmented_launches
    for mod in (module, *also):
        setattr(mod, name, spy)
    try:
        res = fn()
    finally:
        for mod in (module, *also):
            setattr(mod, name, real)
        real.launches = spy.launches
        if hasattr(real, "segmented_launches"):
            real.segmented_launches = spy.segmented_launches
    assert seen, f"{name} was not launched"
    return res, seen[0]


def held_to_plain(torch, name, call, where="at a shard's shape"):
    """A captured kernel call (``spy_first``) against its plain version on
    the same inputs: the largest difference (0; else raises)."""
    from php_aho_corasick_tpu_torch.ops.filter_cuda import _bank_probe_torch
    from php_aho_corasick_tpu_torch.ops.filter_torch import (
        bloom_hit_take, u32,
    )
    from php_aho_corasick_tpu_torch.ops.scan_cuda import (
        _scan_states_tile_torch,
    )

    args, kw, got = call
    if name == "fused_sampled_extract":
        want = plain(args, kw)
    elif name == "bloom_word_vmem":
        table, code, *rest = args
        got, want = [got], [_bank_probe_torch(table, u32(code), *rest)]
    elif name == "bloom_hit":
        got, want = [got], [bloom_hit_take(*args)]
    else:
        want = _scan_states_tile_torch(*args, n_classes=kw["n_classes"],
                                       lengths=kw.get("lengths"))
    torch.cuda.synchronize()
    return compare(got, want, f"{name} {where}")


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


def phase_shard_path(torch, card, kernels, head, planted, tile_cell, sig,
                     base):
    """Phase 11: the data mesh, ``SHARDS`` shards of the one card.  (a)
    the headline's 128 MiB through ``device_corpus(shard=True)`` and
    ``match_arrays_many([handle] * 12)``: records equal to the unsharded
    handle's, per-shard record counts equal to a host split of them, ms a
    pass by CUDA events in turns with the unsharded handle, launches a pass
    by trace, no host sync in the sharded dispatch; (b) phase 4's planted
    64 MiB sharded: every planted needle found, records equal to phase
    4's, per-shard record counts equal to a host split; (c) ``match_arrays`` sharded through the tile, dfa, k-gram,
    anchored, rows, take-grouped, headline-compressed and signature-byte
    cells, each equal to its unsharded records, the compressed table held
    once on the card; (d) ``dryrun_multichip(SHARDS, "cuda")``; (e) two
    processes on the card over 16 MiB of planted documents.  Each kernel's first launch of the phase, at a
    shard's shape, is held against its plain version.  Returns the hand
    kernels' launches of the phase and their largest difference."""
    import dataclasses

    from php_aho_corasick_tpu_torch import Matcher, ScanConfig
    from php_aho_corasick_tpu_torch.ops import filter_cuda, scan_cuda
    from php_aho_corasick_tpu_torch.parallel.dryrun import dryrun_multichip
    from php_aho_corasick_tpu_torch.parallel.mesh import local_shards

    needles, m, h, warm = head
    hd, rd = planted
    cm = m.cascade_model
    err = 0
    counts_zeroed(kernels)
    with local_shards(SHARDS):
        # (a) the headline, sharded
        docs = [row.tobytes() for row in base] * HEADLINE_REPS
        hs = m.device_corpus(docs, shard=True)
        assert len(hs.mesh) == SHARDS and len(hs.chunks_d) == SHARDS
        assert all(c.device == h.chunks_d.device for c in hs.chunks_d)
        res, call = spy_first(filter_cuda, "fused_sampled_extract",
                              lambda: m.match_arrays(hs))
        same_arrays(res, warm, "sharded headline")
        err = max(err, held_to_plain(torch, "fused_sampled_extract", call))
        log(f"phase 11a: headline sharded over {SHARDS} shards of "
            f"{hs.mesh.home}: rows {[tuple(c.shape) for c in hs.chunks_d]}; "
            f"fused_sampled_extract at a shard's phases "
            f"{tuple(call[0][1].shape)}: bit-equal to its plain version")
        m.match_arrays_many([hs] * BATCH)  # warm the batch structure
        fse = kernels[0]
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
        def cell(name, mm, hh, want, spy=None):
            t0 = time.perf_counter()
            if spy is None:
                got = mm.match_arrays(hh)
            else:
                got, call = spy_first(spy[0], spy[1],
                                      lambda: mm.match_arrays(hh))
                cell.err = max(cell.err, held_to_plain(torch, spy[1], call))
            wall = (time.perf_counter() - t0) * 1e3
            same_arrays(got, want, f"sharded {name}")
            log(f"phase 11c: {name} sharded "
                f"({mm._pick_engine(hh.total_bytes)}, "
                f"{hh.total_bytes / 2**20:.0f} MiB, {len(hh.mesh)} shards): "
                f"{got['doc'].shape[0]} records equal to unsharded; "
                f"{wall:.1f} ms host clock"
                + (f"; {spy[1]} at a shard's shape bit-equal to plain"
                   if spy else ""))
            return got

        cell.err = 0
        specs, th, res_tile, res_dfa = tile_cell
        tdocs = [row.tobytes() for row in base] * TILE_REPS
        mt = Matcher(specs, ScanConfig(backend="device",
                                       match_capacity=TILE_CAPACITY),
                     device=DEVICE)
        cell("tile", mt, mt.device_corpus(tdocs, shard=True), res_tile,
             (scan_cuda, "scan_states_tile"))
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
        for name, length, cfg in (
            ("anchored", ANCHORED_LEN, dict(engine="cascade")),
            ("rows", ROWS_LEN, {}),
        ):
            mm = Matcher([{"id": i, "value": p}
                          for i, p in enumerate(needle_set(length))],
                         ScanConfig(backend="device", chunk_len=4096, **cfg),
                         device=DEVICE)
            cdocs = tdocs[:n8] if name == "anchored" else tdocs
            want = mm.match_arrays(mm.device_corpus(cdocs, shard=False))
            cell(name, mm, mm.device_corpus(cdocs, shard=True), want,
                 (filter_cuda, "bloom_hit" if name == "anchored"
                  else "bloom_word_vmem"))
        specs_h = [{"id": i, "value": v} for i, v in enumerate(needles)]
        mg = Matcher(specs_h, ScanConfig(backend="device", chunk_len=4096,
                                         bloom_impl="take"), device=DEVICE)
        assert mg.cascade_model.take_branch(hs.packed.row_len) == "grouped"
        cell("take-grouped", mg, hs, mg.match_arrays(h),
             (filter_cuda, "bloom_hit"))
        mc = Matcher(specs_h, ScanConfig(backend="device", chunk_len=4096,
                                         table_format="compressed"),
                     device=DEVICE)
        cell("headline-compressed", mc, hds, rd)
        ms_, sdocs, res_sig, res_sdfa, n_slice = sig
        cell("signature-byte", ms_, ms_.device_corpus(sdocs, shard=True),
             res_sig)
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
        err = max(err, cell.err)
        launched = launched_of(kernels)

    # (d) the dry run; (e) two processes on the card
    log(f"phase 11d: {dryrun_multichip(SHARDS, DEVICE)}")
    phase_two_processes(torch, card, m)
    assert all(n > 0 for n in launched), launched
    log(f"phase 11 hand kernel launches (fused, rows, bloom_hit, tile): "
        f"{launched}")
    return launched, err


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


def phase_remaining_surface(torch, card, kernels, head, planted, sig,
                            sig_build_s):
    """Phase 12: the native builder beside the numpy one, matcher files,
    the profiling hooks, the command line and the examples on the card
    (the module docstring's item 12).  Returns the hand kernels' launches
    of the phase and their largest difference from their plain versions
    at its shapes."""
    import glob
    import math
    import os
    import shutil

    from php_aho_corasick_tpu_torch import Matcher, ScanConfig, native
    from php_aho_corasick_tpu_torch.examples import (
        basic, bulk_scan, serving_loop,
    )
    from php_aho_corasick_tpu_torch.models import tile_dfa
    from php_aho_corasick_tpu_torch.ops import filter_cuda, scan_cuda
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
    err = 0

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

    counts_zeroed(kernels)
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
    got, call = spy_first(filter_cuda, "bloom_hit",
                          lambda: ml.match_arrays_many([hl])[0])
    first_s = time.perf_counter() - t0
    for key in res_sig:
        assert np.array_equal(got[key], res_sig[key]), f"loaded sig {key}"
    err = max(err, held_to_plain(torch, "bloom_hit", call,
                                 "at the loaded signature-byte shape"))
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
    got, call = spy_first(filter_cuda, "fused_sampled_extract",
                          lambda: mh.match_arrays_many([hd])[0])
    for key in rd:
        assert np.array_equal(got[key], rd[key]), f"loaded headline {key}"
    err = max(err, held_to_plain(torch, "fused_sampled_extract", call,
                                 "at the loaded headline's shape"))
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
    recs, call = spy_first(scan_cuda, "scan_states_tile",
                           lambda: mi.match(data), also=(tile_dfa,))
    err = max(err, held_to_plain(torch, "scan_states_tile", call,
                                 "at the command line's shape"))
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
    counts, call = spy_first(filter_cuda, "fused_sampled_extract",
                             bulk_scan.main)
    assert len(counts) == 3 and min(counts) >= 1, counts
    err = max(err, held_to_plain(torch, "fused_sampled_extract", call,
                                 "at the bulk_scan example's shape"))
    recs = serving_loop.main()
    assert recs and recs[0]["keyIdx"] == 42, recs
    log(f"phase 12e: the three examples at their default sizes in "
        f"{time.perf_counter() - t0:.1f} s (bulk_scan's batches found "
        f"{counts} matches)")
    launched = launched_of(kernels)
    shutil.rmtree(work)
    log(f"phase 12 hand kernel launches (fused, rows, bloom_hit, tile): "
        f"{launched}")
    return launched, err


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
    )
    from php_aho_corasick_tpu_torch.ops.scan_cuda import (
        _scan_states_tile_torch,
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
    n_hits, err1 = phase_kernel_random(torch, fse, plain)
    log(f"kernel check 1 (random tables, shorts, pack=1): bit-equal, "
        f"{n_hits} hits")
    n_fc, err_fc = phase_fused_cases(torch, fse, plain)
    log(f"kernel check 1b (fused, {n_fc} cases: spc 1-4 x pack 1/2/4 x q "
        f"1/9/16, prefix on/off, tables over the shared budget): "
        f"bit-equal")
    n_cases, tile_err = phase_tile_random(torch, sst, _scan_states_tile_torch)
    log(f"kernel check 3 (scan_states_tile, {n_cases} random tables): "
        f"bit-equal")
    n_sync, sync_err = phase_tile_sync(torch, sst, _scan_states_tile_torch)
    log(f"kernel check 3b (scan_states_tile with sync_len, {n_sync} "
        f"Aho-Corasick tables): bit-equal")
    n_vmem, vmem_err, n_hit, hit_err = phase_bloom_random(torch, bwv, bh)
    log(f"kernel check 4 (bloom_word_vmem, {n_vmem} random tables; "
        f"bloom_hit, {n_hit} random blooms): bit-equal")

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
    want = plain(args, kw)
    torch.cuda.synchronize()
    err2 = compare(got, want, "headline plan, prefix refine")
    n_blocks = got[4].shape[0]
    log(f"kernel check 2 (headline plan, mpr {kw['mpr']}, {n_blocks} "
        f"blocks, prefix refine): bit-equal, {int(got[4].sum())} hits")
    k_ms = cuda_ms(lambda: fse(*args, **kw), 50)
    p_ms = cuda_ms(lambda: plain(args, kw), 3)
    b_ms, b_by, b_bytes, b_ops = bound_ms(args, kw, got)
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
    assert all(r["doc"].shape == res[0]["doc"].shape for r in res)
    for key in res[0]:
        assert np.array_equal(res[0][key], warm[key]), key
    log(f"main path: match_arrays_many([handle] * {BATCH}) over "
        f"{total / 2**20:.0f} MiB: {ms:.3f} ms/pass by CUDA events "
        f"({wall * 1e3:.3f} ms wall), {total / ms / 1e6:.2f} GB/s, "
        f"{res[0]['doc'].shape[0]} matches/pass, kernel launches "
        f"{launches}, on {card}")

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

    # 5. the tile path
    tile_cell, tile_kernel = phase_tile_path(
        torch, base, card, sst, _scan_states_tile_torch,
        ptxas_lines(report, "scan_states_tile"))
    tile_kernel["max_abs_err"] = max(tile_kernel["max_abs_err"], tile_err,
                                     sync_err)

    # 6. the rows path, 7. the anchored path
    rows_kernel = phase_rows_path(torch, base, card, bwv,
                                  ptxas_lines(report, "bloom_word_vmem"),
                                  parent)
    rows_kernel["max_abs_err"] = max(rows_kernel["max_abs_err"], vmem_err)
    hit_kernel = phase_anchored_path(torch, base, card, bh)
    hit_kernel["max_abs_err"] = max(hit_kernel["max_abs_err"], hit_err)

    # 8. the take filters; bloom_hit's launches count both of its paths
    take_hits, take_err = phase_take_path(torch, base, card, (needles, h, warm),
                                          (fse, bwv, bh, sst))
    hit_kernel["launches"] += take_hits
    hit_kernel["max_abs_err"] = max(hit_kernel["max_abs_err"], take_err)

    # 9. the compressed table, the flagged-window verify, the k-gram engine
    kernels = (fse, bwv, bh, sst)
    sig_launched, sig_err, sig, sig_build_s = phase_signature_path(
        torch, card, kernels)
    comp_launched, comp_err = phase_compressed_path(
        torch, card, kernels, (needles, m, hd, rd))
    kgram_launched = phase_kgram_path(torch, card, kernels, tile_cell)
    hit_kernel["max_abs_err"] = max(hit_kernel["max_abs_err"], sig_err)
    # each count in the order of ``kernels``: fused, rows, bloom_hit, tile
    extra = [sum(c) for c in zip(sig_launched, comp_launched, kgram_launched)]
    launches += extra[0]
    for k, n in zip((rows_kernel, hit_kernel, tile_kernel), extra[1:]):
        k["launches"] += n

    # 10. serving and streaming: the fresh-corpus pipeline, the cross-batch
    # double buffer, the stream's two carries, iter_matches, replace, warmup
    serve_launched, serve_err = phase_serving_path(
        torch, card, kernels, (needles, m, h, hd, rd), tile_cell, base)
    launches += serve_launched[0]
    for k, n in zip((rows_kernel, hit_kernel, tile_kernel),
                    serve_launched[1:]):
        k["launches"] += n
    err2 = max(err2, serve_err)

    # 11. the data mesh: 4 shards of the card
    shard_launched, shard_err = phase_shard_path(
        torch, card, kernels, (needles, m, h, warm), (hd, rd), tile_cell, sig,
        base)
    launches += shard_launched[0]
    for k, n in zip((rows_kernel, hit_kernel, tile_kernel),
                    shard_launched[1:]):
        k["launches"] += n
    err2 = max(err2, shard_err)

    # 12. the native builder, matcher files, profiling, the CLI, examples
    rest_launched, rest_err = phase_remaining_surface(
        torch, card, kernels, (needles, m, h, warm, base), (hd, rd), sig,
        sig_build_s)
    launches += rest_launched[0]
    for k, n in zip((rows_kernel, hit_kernel, tile_kernel),
                    rest_launched[1:]):
        k["launches"] += n
    err2 = max(err2, rest_err)

    # 13. timings and the last line
    kernels = [{
        "name": "fused_sampled_extract",
        "route": "cuda",
        "source": "php_aho_corasick_tpu_torch/csrc/fused_sampled_extract.cu",
        "replaces": "php_aho_corasick_tpu/ops/filter_pallas.py:765",
        "launches": launches,
        "max_abs_err": max(err1, err_fc, err2, comp_err),
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    }, tile_kernel, rows_kernel, hit_kernel]
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
