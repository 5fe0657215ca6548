#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving paths on one CUDA card and check
them.

Run from the repository root:  python3 chip_smoke.py

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
6. one JSON line of kernel timings, the card's name and power limit, and
   the last line ``{"ok": true, "device": {...}}``.
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
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
NON_TENSOR_OPS_PER_S = 67e12  # its fp32 rate outside the tensor cores


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
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


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


def bound_ms(args, kw, out):
    """Least time for the fused filter on these inputs: each input read
    and each output written once over the memory rate, against the
    integer operations this data needs (q-gram assembly, the salted probes
    until the AND reaches zero, hit test) over the non-tensor rate."""
    import torch

    from php_aho_corasick_tpu_torch.ops.filter_cuda import _bank_probe_torch
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
    probes = torch.zeros(n, dtype=torch.int64, device=table.device)
    alive = torch.ones(n, dtype=torch.bool, device=table.device)
    acc = None
    per_salt = table.reshape(len(kw["salts"]), -1)
    for p, salt in enumerate(kw["salts"]):
        probes += alive
        w = _bank_probe_torch(per_salt[p], code, (salt,), kw["log2_rows"],
                              kw["pack"])
        acc = w if acc is None else acc & w
        alive = acc != 0
    ops = n * (4 * q + 4) + 12 * int(probes.sum().item())
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / NON_TENSOR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), n_bytes, ops


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


def tile_bound_ms(table, chunks, n_classes):
    """Least time for the tile scan of ``chunks``: the bytes read and the
    int32 states written once (plus table, class map, init, lengths and
    carry), against 3 operations per byte (class lookup, multiply-add,
    table load) over the non-tensor rate."""
    B, L = chunks.shape
    n_bytes = B * L * (1 + 4) + B * 4 * 3 + table.numel() * 4 + 256 * 4
    ops = 3 * B * L
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / NON_TENSOR_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", n_bytes, ops)


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


def phase_tile_path(torch, base, card, sst, plain_fn):
    """The tile path at 32 MiB: route, timed passes, kernel against its
    bound, where the pass time goes, and the records against the host
    walk, the dense engine, the default capacity and ``match_many``."""
    from php_aho_corasick_tpu_torch import (
        Matcher, ScanConfig, ahocorasick_init, ahocorasick_match,
    )
    from php_aho_corasick_tpu_torch.ops.matches import expand_matches_arrays
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
    for key in res:
        assert np.array_equal(res[key], warm[key]), key
    n_rec = res["doc"].shape[0]
    log(f"tile path: match_arrays(handle) x {TILE_PASSES}: {ms:.3f} ms/pass "
        f"by CUDA events, {total / ms / 1e6:.3f} GB/s, {n_rec} matches/pass, "
        f"kernel launches {launches}, on {card}")
    trace_breakdown(torch, lambda n: [m.match_arrays(h) for _ in range(n)],
                    card)

    # the kernel on the probe table at this shape, against plain and bound
    tm = m.tile_model
    dev = tm.device_arrays
    init = torch.zeros((B,), dtype=torch.int32, device=DEVICE)
    args = (dev["table_flat"], dev["byte_class"], dev["used_bytes"],
            h.chunks_d, init, auto.n_classes)
    got = sst(*args, lengths=h.lengths_d)
    want = plain_fn(*args, h.lengths_d)
    torch.cuda.synchronize()
    err = compare(got, want, "tile kernel, probe table, 32 MiB")
    k_ms = cuda_ms(lambda: sst(*args, lengths=h.lengths_d), 20)
    p_ms = cuda_ms(lambda: plain_fn(*args, h.lengths_d), 3)
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
    log(f"scan_states_tile at [{B}, {L}]: {k_ms:.4f} ms (plain {p_ms:.3f} "
        f"ms, bound {b_ms:.4f} ms by {b_by}: {b_bytes} bytes, {b_ops} ops) "
        f"on {card}")
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
    return {
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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from php_aho_corasick_tpu_torch import Matcher, ScanConfig
    from php_aho_corasick_tpu_torch.ops import _build
    from php_aho_corasick_tpu_torch.ops.filter_cuda import (
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
        info = [ln for ln in r["log"].splitlines() if "ptxas info" in ln]
        log(f"  {name}: {r['seconds']:.2f} s; " + " | ".join(info[-2:]))

    # 2a. kernel vs plain: random tables, shorts, pack=1
    n_hits, err1 = phase_kernel_random(torch, fse, plain)
    log(f"kernel check 1 (random tables, shorts, pack=1): bit-equal, "
        f"{n_hits} hits")
    n_cases, tile_err = phase_tile_random(torch, sst, _scan_states_tile_torch)
    log(f"kernel check 3 (scan_states_tile, {n_cases} random tables): "
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
        f"(plain {p_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by}: "
        f"{b_bytes} bytes, {b_ops} ops) on {card}")

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
    fse.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = m._records_batch_dispatch([h] * 2, cm)
        sync = "no host sync in the records dispatch"
    except RuntimeError as e:
        pending = None
        sync = f"HOST SYNC in the records dispatch: {str(e)[:200]}"
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if pending is not None:
        m._records_batch_finish(*pending, True)
    log(f"sync check (set_sync_debug_mode='error'): {sync}")

    # 4. planted matches against a host DFA walk
    dens = np.repeat(base[None], DENSITY_REPS, axis=0).reshape(-1, DOC_BYTES)
    prng = random.Random(int(DENSITY * 1e9))
    n_plant = int(DENSITY * dens.size)
    planted = []
    for _ in range(n_plant):
        di = prng.randrange(dens.shape[0])
        off = prng.randrange(DOC_BYTES - NEEDLE_LEN)
        pid = prng.randrange(N_NEEDLES)
        dens[di, off : off + NEEDLE_LEN] = np.frombuffer(needles[pid], np.uint8)
        planted.append((di, off, pid))
    hd = m.device_corpus([row.tobytes() for row in dens])
    rd = m.match_arrays_many([hd])[0]
    found = set(zip(rd["doc"].tolist(), rd["pos"].tolist(),
                    rd["pattern"].tolist()))
    intact = [(d, o + NEEDLE_LEN, p) for d, o, p in planted
              if dens[d, o : o + NEEDLE_LEN].tobytes() == needles[p]]
    missing = [x for x in intact if x not in found]
    assert not missing, f"planted needles not found: {missing[:5]}"
    n_slice = (8 << 20) // DOC_BYTES
    ref = host_walk(m.automaton, dens[:n_slice])
    sel = rd["doc"] < n_slice
    got_arr = np.stack([rd["doc"][sel], rd["pos"][sel], rd["pattern"][sel]])
    assert np.array_equal(got_arr, ref), "8 MiB slice differs from host walk"
    assert np.array_equal(rd["start_postion"], rd["pos"] - NEEDLE_LEN)
    log(f"planted corpus: {dens.size / 2**20:.0f} MiB, {n_plant} planted, "
        f"{len(intact)} intact all found, {rd['doc'].shape[0]} matches; "
        f"8 MiB slice equals the host walk ({ref.shape[1]} matches)")

    # 5. the tile path
    tile_kernel = phase_tile_path(torch, base, card, sst,
                                  _scan_states_tile_torch)
    tile_kernel["max_abs_err"] = max(tile_kernel["max_abs_err"], tile_err)

    # 6. timings and the last line
    kernels = [{
        "name": "fused_sampled_extract",
        "route": "cuda",
        "source": "php_aho_corasick_tpu_torch/csrc/fused_sampled_extract.cu",
        "replaces": "php_aho_corasick_tpu/ops/filter_pallas.py:765",
        "launches": launches,
        "max_abs_err": max(err1, err2),
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    }, tile_kernel]
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
