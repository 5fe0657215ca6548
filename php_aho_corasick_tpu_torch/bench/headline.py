"""The headline record: the JAX package's ``bench.py`` on the port.

Workload (``bench.py:89-302``): 2048 needles x 16 bytes over ``abcdef``
and 256 base documents of 8 KiB, all from ``random.Random(1337)``; the
2 MiB of base documents replicated 64 times is the 128 MiB resident
corpus.  Timed: ``device_corpus`` + ``match_arrays_many([handle] * 12)``
(the median of five batches), ``match_many`` end to end, the cold path
(host pack, upload, a fresh ``match_arrays``), and the match-density rows
at 1e-5 and 1e-3 planted needles a byte over 64 MiB through
``match_arrays_stream`` (3 batches of 8, the median of 3 runs).  The
record has ``BENCH_TPU_LAST.json``'s keys; ``detail.device`` is the card
and its power limit.

    python -m php_aho_corasick_tpu_torch.bench.headline [--device cpu]
        [--artifact PATH] [--signature-artifact PATH ...]

``run(mib=..., reps=...)`` cuts the corpus and the passes of a timed batch
(the CPU tests run it small); the command line has the reference's
sizes only.
"""

from __future__ import annotations

import json
import random
import sys
import time
from typing import List, Optional, Sequence

import torch

from .. import Matcher, ScanConfig
from ..api import resolve_device
from ..ops.matches import pack_documents
from . import _timing

N_NEEDLES, NEEDLE_LEN, ALPHABET = 2048, 16, b"abcdef"
DOC_BYTES, N_BASE_DOCS = 8192, 256
MIB = 128  # the 2 MiB of base documents, 64 times
BATCH, BATCHES = 12, 5  # passes a timed batch; timed batches (median)
DENSITIES = (1e-5, 1e-3)  # planted needles a byte
DENSITY_BATCH, DENSITY_BATCHES, DENSITY_RUNS = 8, 3, 3


def draws(seed: int = 1337):
    """``bench.py:91-102``: the sorted needles and the base documents."""
    rng = random.Random(seed)
    needles = set()
    while len(needles) < N_NEEDLES:
        needles.add(bytes(rng.choice(ALPHABET) for _ in range(NEEDLE_LEN)))
    needles = sorted(needles)
    base_docs = [
        bytes(rng.choice(ALPHABET) for _ in range(DOC_BYTES))
        for _ in range(N_BASE_DOCS)
    ]
    return needles, base_docs


def corpus(base_docs: Sequence[bytes], n_bytes: int) -> List[bytes]:
    """``n_bytes`` of the base documents repeated in order (``base_docs *
    64`` at 128 MiB, ``* 32`` at 64 MiB)."""
    return [base_docs[i % len(base_docs)]
            for i in range(n_bytes // DOC_BYTES)]


def planted(dens_docs: Sequence[bytes], needles: Sequence[bytes],
            dens: float):
    """``bench.py``'s density plants: ``int(dens * bytes)`` needles, each
    at a document and offset drawn from ``random.Random(int(dens *
    1e9))``.  Returns ``(documents, plants)``, the plants as ``(document,
    offset, needle)`` in their order (a later plant may overwrite an
    earlier one)."""
    n_plant = int(dens * sum(map(len, dens_docs)))
    prng = random.Random(int(dens * 1e9))
    docs = [bytearray(d) for d in dens_docs]
    plants = []
    for _ in range(n_plant):
        di = prng.randrange(len(docs))
        off = prng.randrange(DOC_BYTES - NEEDLE_LEN)
        nd = needles[prng.randrange(len(needles))]
        docs[di][off : off + NEEDLE_LEN] = nd
        plants.append((di, off, nd))
    return [bytes(d) for d in docs], plants


def surviving(docs: Sequence[bytes], plants) -> int:
    """Plants still whole in ``docs``, one a (document, offset): each is a
    match the scan must report."""
    return len({(di, off) for di, off, nd in plants
                if docs[di][off : off + NEEDLE_LEN] == nd})


def signature_scale(paths: Sequence[str]) -> Optional[dict]:
    """The ``signatures`` tool's records at ``paths``, by alphabet (the
    reference embeds ``benchmarks/signature_last.json`` so)."""
    if not paths:
        return None
    out = {}
    for path in paths:
        with open(path) as f:
            rec = json.load(f)
        out[rec["alphabet"]] = rec
    return out


def run(mib: int = MIB, reps: int = BATCH, device=None,
        signature_artifacts: Sequence[str] = ()) -> dict:
    """The headline record (``bench.py``'s keys) on ``device`` (default:
    the CUDA card; raises with none)."""
    device = resolve_device(device)
    kernels = _timing.Kernels(device)
    needles, base_docs = draws()
    docs = corpus(base_docs, mib << 20)
    total_bytes = sum(map(len, docs))

    cfg = ScanConfig(backend="device", chunk_len=4096)
    t0 = time.perf_counter()
    m = Matcher([{"id": i, "value": p} for i, p in enumerate(needles)], cfg,
                device=device)
    m.finalize()
    build_s = time.perf_counter() - t0

    # the planted spot check through the whole pipeline
    spot = base_docs[0][:100] + needles[7] + base_docs[0][100:]
    if not any(r["keyIdx"] == 7 and r["pos"] == 116 for r in m.match(spot)):
        raise RuntimeError("planted needle not found")

    auto = m.automaton
    engine = m._pick_engine(total_bytes)
    cm = m.cascade_model
    use_cascade = engine == "cascade" and cm is not None

    handle = m.device_corpus(docs)
    kernels.hold(lambda: m.match_arrays_many([handle]))
    res = m.match_arrays(handle)  # settles the capacities
    m.match_arrays(handle)
    pass_matches = int(res["doc"].shape[0])
    caps_before = (cm._cap_hits, cm._cap_flagged) if use_cascade else None

    def batch():
        m.match_arrays_many([handle] * reps)

    batch()  # warms the batch structure
    batch_ms = _timing.runs_ms(device, batch, BATCHES, per=reps)
    dt = batch_ms[BATCHES // 2] / 1e3
    caps_moved = (
        use_cascade and (cm._cap_hits, cm._cap_flagged) != caps_before
    )
    gbps = total_bytes / dt / 1e9

    e2e_ms, _ = _timing.call_ms(device, lambda: m.match_many(docs))

    # the cold corpus: host pack, upload, and a fresh match_arrays call
    t0 = time.perf_counter()
    pk = pack_documents(docs, m._pack_chunk_len(), auto.max_len - 1,
                        row_align=m._row_align())
    pack_s = time.perf_counter() - t0
    upload_ms, up = _timing.call_ms(
        device, lambda: torch.as_tensor(pk.chunks).to(device))
    del up, pk
    m.match_arrays(docs)  # warms the sliced shapes once
    cold_ms, _ = _timing.call_ms(device, lambda: m.match_arrays(docs))
    cold = {
        "pack_gbps": round(total_bytes / pack_s / 1e9, 3),
        "upload_gbps": round(total_bytes / upload_ms / 1e6, 3),
        "cold_scan_gbps": round(total_bytes / cold_ms / 1e6, 4),
        "engine": m.stats.last_engine,
    }

    # the match-density axis: the full public pipeline over planted
    # corpora, capacities seeded from the known density
    density_rows = {}
    dens_docs = corpus(base_docs, total_bytes // 2)
    dens_bytes = sum(map(len, dens_docs))
    dreps = min(DENSITY_BATCH, reps)
    for dens in DENSITIES:
        pdocs, plants = planted(dens_docs, needles, dens)
        n_plant = len(plants)
        if use_cascade:
            cm.seed_caps(2 * n_plant, 2 * n_plant)
        hd = m.device_corpus(pdocs)
        del pdocs
        retries0 = m.stats.capacity_retries
        res_d = m.match_arrays(hd)  # warm + settle caps
        m.match_arrays(hd)
        cold_retries = m.stats.capacity_retries - retries0
        batches = [[hd] * dreps for _ in range(DENSITY_BATCHES)]

        def stream():
            list(m.match_arrays_stream(batches))

        stream()  # warms the batch structure
        dms = _timing.runs_ms(device, stream, DENSITY_RUNS,
                              per=dreps * DENSITY_BATCHES)
        density_rows[f"{dens:g}"] = {
            "gbps": round(dens_bytes / dms[1] / 1e6, 4),
            "gbps_spread": [
                round(dens_bytes / t / 1e6, 4) for t in reversed(dms)
            ],
            "pass_ms": round(dms[1], 2),
            "matches": int(res_d["doc"].shape[0]),
            "corpus_mib": round(dens_bytes / 2**20, 1),
            "cold_capacity_retries": int(cold_retries),
        }
        del hd, batches

    return {
        "metric": "scan_throughput_2048x16_needles",
        "value": round(gbps, 4),
        "unit": "GB/s/chip",
        "vs_baseline": round(gbps / _timing.REFERENCE_GBPS, 1),
        "detail": {
            "corpus_mib": round(total_bytes / 2**20, 1),
            "pass_ms": round(dt * 1e3, 2),
            "pass_ms_spread": [round(t, 2) for t in batch_ms],
            "public_api": "device_corpus + match_arrays_many",
            "caps_moved_during_timing": bool(caps_moved),
            # the reference's name, kept so the records compare; here
            # the upload is a host-to-card copy, not a relay
            "e2e_gbps_via_relay": round(total_bytes / e2e_ms / 1e6, 4),
            "e2e_path": "match_many: host pack, upload and expansion "
                        "included; no relay on this host",
            "cold_path": cold,
            "build_s": round(build_s, 3),
            "engine": (
                f"cascade/{cm.plan.reason}" if use_cascade
                else (
                    f"kgram k={m.kgram_model.k}"
                    if engine == "kgram" else engine
                )
            ),
            "states": auto.n_states,
            # random abcdef with nothing planted: 0 matches, the
            # filter-bound number; emission is the density rows'
            "matches": pass_matches,
            "match_density_gbps": density_rows,
            "signature_scale": signature_scale(signature_artifacts),
            "device": _timing.card_line(device),
        },
        "kernels": kernels.record(),
    }


def main(argv=None) -> int:
    ap = _timing.parser(__doc__.split("\n\n")[0])
    ap.add_argument("--signature-artifact", action="append", default=[],
                    metavar="PATH",
                    help="a signatures record to embed as signature_scale")
    a = ap.parse_args(argv)
    _timing.finish(run(device=a.device,
                       signature_artifacts=a.signature_artifact),
                   a.artifact)
    return 0


if __name__ == "__main__":
    sys.exit(main())
