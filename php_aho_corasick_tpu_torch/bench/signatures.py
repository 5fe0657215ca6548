"""Signature-scale record: the JAX package's
``benchmarks/bench_signatures.py`` on the port.

1M needles (antivirus / IDS signature lists) of 16 symbols from
``numpy.random.default_rng(7)``: ``--alphabet hex`` (16 symbols; the
dense table holds) or ``--alphabet byte`` (256; the compressed table).
The same generator then draws the corpus, ``--mib`` MiB in 1 MiB
documents with 200 needles planted (none across a document boundary).
Timed: the native build, the cascade's plan (host clock), the cascade
over a resident handle (``match_arrays_many([handle] * 8)``, the median
of 3 batches) and the 1-gram DFA fallback over the same packed rows
(``model.scan_compact_device``: the dense or the compressed walk).  The
record has ``benchmarks/signature_last.json``'s keys for one alphabet,
plus the plan's seconds, the hash seed, the device and the kernels.

    python -m php_aho_corasick_tpu_torch.bench.signatures
        [--alphabet hex|byte] [--needles 1000000] [--mib 64] [--device cpu]
        [--artifact PATH]

The needle list is the reference's ``list(set)``, whose order (the ids,
and so which needle each plant takes) follows ``PYTHONHASHSEED``; the
record names the hash seed it ran under.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import Matcher, ScanConfig, native
from ..api import resolve_device
from ..ops.matches import pack_documents
from . import _timing

DOC_BYTES = 1 << 20
N_PLANTS = 200  # one plant every 1/200 of the corpus
BATCH, BATCHES = 8, 3
DFA_CAPACITY = 1 << 16


def draws(alphabet: str, n_needles: int, needle_len: int, mib: int):
    """``bench_signatures.py:49-79``: ``(patterns, documents, planted)``,
    the needles as the reference's ``list(set)`` of bytes."""
    rng = np.random.default_rng(7)
    if alphabet == "hex":
        amap = np.frombuffer(b"0123456789abcdef", np.uint8)

        def draw(n):
            return amap[rng.integers(0, 16, n, dtype=np.uint8)]
    else:
        def draw(n):
            return rng.integers(0, 256, n, dtype=np.uint8)
    raw = draw((n_needles, needle_len))
    patterns = list({bytes(raw[i]) for i in range(n_needles)})

    n_bytes = mib * 2**20
    corpus = bytearray(draw(n_bytes))
    n_planted = 0
    for j in range(0, n_bytes - 16, max(n_bytes // N_PLANTS, 1)):
        if j % DOC_BYTES > DOC_BYTES - needle_len:
            continue  # would straddle a document boundary
        corpus[j : j + needle_len] = patterns[j % len(patterns)]
        n_planted += 1
    docs = [bytes(corpus[i : i + DOC_BYTES])
            for i in range(0, n_bytes, DOC_BYTES)]
    return patterns, docs, n_planted


def run(alphabet: str = "hex", n_needles: int = 1_000_000,
        needle_len: int = 16, mib: int = 64, device=None) -> dict:
    """One alphabet's signature record on ``device`` (default: the CUDA
    card; raises with none)."""
    device = resolve_device(device)
    kernels = _timing.Kernels(device)
    patterns, docs, n_planted = draws(alphabet, n_needles, needle_len, mib)
    n_bytes = mib * 2**20

    t0 = time.perf_counter()
    cfg = ScanConfig(backend="device", chunk_len=4096)
    m = Matcher([{"id": i, "value": p} for i, p in enumerate(patterns)],
                cfg, device=device)
    m.finalize()
    build_s = time.perf_counter() - t0
    auto = m.automaton
    print(f"build: {build_s:.1f}s  states={auto.n_states:,} "
          f"table={auto.table_bytes / 2**20:.0f} MiB "
          f"format={m.table_format} (native={native.available()})",
          flush=True)
    t0 = time.perf_counter()
    m.cascade_model  # the plan
    plan_s = time.perf_counter() - t0
    engine = m._pick_engine(n_bytes)

    packed = pack_documents(docs, m._pack_chunk_len(), auto.max_len - 1,
                            row_align=m._row_align())
    rows = [torch.from_numpy(x).to(device)
            for x in (packed.chunks, packed.lengths, packed.emit_from)]
    del packed

    def launch_dfa():
        _idx, _sts, nd, _carry = m.model.scan_compact_device(
            *rows, None, DFA_CAPACITY)
        return int(nd)

    cm = m.cascade_model if engine == "cascade" else None
    if cm is not None:
        print(f"engine: cascade ({cm.plan.reason}, "
              f"bloom {4 << cm.plan.log2_words >> 20} MiB, "
              f"device_verify={cm.device_verify_ok}, "
              f"records={cm.records_ok}); plan {plan_s:.1f}s", flush=True)
        handle = m.device_corpus(docs)

        def launch():
            return int(m.match_arrays(handle)["doc"].shape[0])
    else:
        print(f"engine: {engine} (dense dfa fallback)", flush=True)
        launch = launch_dfa
    del docs
    kernels.hold(launch)
    n = launch()  # warm
    n = launch()  # adaptive capacities settle
    if cm is not None:
        def batch():
            m.match_arrays_many([handle] * BATCH)

        batch()  # warms the batch structure
        dt = _timing.runs_ms(device, batch, BATCHES, per=BATCH)[1] / 1e3
    else:
        times = []
        for _ in range(BATCHES):
            ms, n = _timing.call_ms(device, launch)
            times.append(ms)
        dt = sorted(times)[BATCHES // 2] / 1e3
    print(f"scan: {dt * 1e3:.0f} ms for {mib} MiB -> "
          f"{n_bytes / dt / 1e9:.3f} GB/s; matches={n} "
          f"(planted {n_planted})", flush=True)
    if n < n_planted:
        raise RuntimeError(f"{n} matches, {n_planted} planted")

    launch_dfa()
    ddt = _timing.call_ms(device, launch_dfa)[0] / 1e3
    print(f"dfa fallback: {ddt * 1e3:.0f} ms -> "
          f"{n_bytes / ddt / 1e9:.3f} GB/s", flush=True)
    return {
        "alphabet": alphabet,
        "needles": len(patterns),
        "needle_len": needle_len,
        "states": int(auto.n_states),
        "table_mib": round(auto.table_bytes / 2**20, 1),
        "table_format": m.table_format,
        "build_s": round(build_s, 1),
        "plan_s": round(plan_s, 1),
        "corpus_mib": mib,
        "gbps": round(n_bytes / dt / 1e9, 4),
        "pass_ms": round(dt * 1e3, 1),
        "matches": int(n),
        "planted": n_planted,
        "dfa_fallback_gbps": round(n_bytes / ddt / 1e9, 4),
        "engine": cm.plan.reason if cm is not None else engine,
        "measured_at": _timing.timestamp(),
        "hash_seed": _timing.hash_seed(),
        "device": _timing.card_line(device),
        "kernels": kernels.record(),
    }


def main(argv=None) -> int:
    ap = _timing.parser(__doc__.split("\n\n")[0])
    ap.add_argument("--needles", type=int, default=1_000_000)
    ap.add_argument("--needle-len", type=int, default=16)
    ap.add_argument("--mib", type=int, default=64)
    ap.add_argument("--alphabet", choices=("hex", "byte"), default="hex")
    a = ap.parse_args(argv)
    _timing.finish(run(a.alphabet, a.needles, a.needle_len, a.mib,
                       a.device), a.artifact)
    return 0


if __name__ == "__main__":
    sys.exit(main())
