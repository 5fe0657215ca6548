"""Data-parallel scaling: the JAX package's ``benchmarks/bench_scaling.py``
on the port.

Bytes/s of one sharded scan at 1, 2, 4 and N shards, and its efficiency
against N times the one-shard rate.  The shards are the first N cards
(``parallel.mesh.data_mesh``) on a host with more than one, else N shards
of the one device (``DataMesh([device] * N)``, as
``parallel.mesh.local_shards`` builds them): the record then says
``"shards_of_one_card": true``, and its efficiency is host dispatch, not
scaling.  The workload is the reference's: 2048 needles x 16 bytes over
``abcdef`` and ``--mib`` MiB of the same alphabet in 1 MiB documents,
from ``numpy.random.default_rng(5)``, the matcher at
``bloom_impl="take"``; ``--engine dfa`` times
``parallel/shard_scan.sharded_scan_compact`` and ``--engine cascade``
``sharded_sampled_verified`` (filter + flagged-window verify).

    python -m php_aho_corasick_tpu_torch.bench.scaling [--devices 8]
        [--mib 32] [--engine dfa|cascade] [--device cpu] [--artifact PATH]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import Matcher, ScanConfig
from ..api import resolve_device
from ..ops.matches import pack_documents
from ..parallel.mesh import data_mesh, replicated, row_sharding
from ..parallel.shard_scan import sharded_sampled_verified, sharded_scan_compact
from ..utils import next_pow2
from . import _timing

DOC_BYTES = 1 << 20
REPS = 3
CAP_FLAGGED, DFA_CAPACITY = 2048, 4096


def draws(mib: int):
    """``bench_scaling.py:54-72``: ``(patterns, documents)``, the needles
    as the reference's ``list(set)``."""
    rng = np.random.default_rng(5)
    alphabet = np.frombuffer(b"abcdef", np.uint8)
    pats = list({
        bytes(alphabet[rng.integers(0, 6, 16)]) for _ in range(2048)
    })
    n_bytes = mib * 2**20
    corpus = bytes(alphabet[rng.integers(0, 6, n_bytes)])
    return pats, [corpus[i : i + DOC_BYTES]
                  for i in range(0, n_bytes, DOC_BYTES)]


def shard_devices(device: torch.device, n: int):
    """``(devices, shards_of_one_card)``: the first ``n`` cards where the
    host has more than one, else ``n`` shards of ``device``."""
    count = torch.cuda.device_count() if device.type == "cuda" else 1
    if count > 1:
        return [torch.device("cuda", i) for i in range(min(n, count))], False
    return [device] * n, True


def run(devices: int = 8, mib: int = 32, engine: str = "dfa",
        device=None) -> dict:
    """The scaling record on ``device`` (default: the CUDA card; raises
    with none)."""
    device = resolve_device(device)
    kernels = _timing.Kernels(device)
    pats, docs = draws(mib)
    m = Matcher([{"id": i, "value": p} for i, p in enumerate(pats)],
                ScanConfig(backend="device", engine=engine,
                           bloom_impl="take"), device=device)
    m.finalize()
    auto = m.automaton
    cm = m.cascade_model if engine == "cascade" else None
    if engine == "cascade" and (cm is None or not cm.device_verify_ok):
        raise RuntimeError("cascade ineligible")
    all_devices, one_card = shard_devices(device, devices)
    n_bytes = mib * 2**20
    packed = pack_documents(docs, 2048, auto.max_len - 1,
                            batch_pad=len(all_devices) * 8)
    del docs

    def launcher(nd):
        mesh = data_mesh(all_devices[:nd])
        ch, ln, ef = (row_sharding(mesh, x) for x in (
            packed.chunks, packed.lengths, packed.emit_from))
        if cm is not None:
            # capacities are per shard: the estimated global hits / nd,
            # 8x headroom (a shard's verify walks its whole capacity)
            est_hits = int(cm.plan.est_cand_density * n_bytes
                           * cm.plan.stride)
            cap_hits = max(2048, next_pow2(8 * est_hits // nd))

            def launch():
                _cells, _nfs, gh, gf, _gc = sharded_sampled_verified(
                    mesh, cm, ch, ln, cap_hits=cap_hits,
                    cap_flagged=CAP_FLAGGED)
                stats = torch.stack([gh, gf]).cpu().numpy()
                if stats[0, 1] > cap_hits or stats[1, 1] > CAP_FLAGGED:
                    raise RuntimeError(f"a shard overflowed: {stats}")
                return int(stats[0, 0])  # filter hits over the shards
        else:
            arrays = replicated(mesh, m.model.device_arrays)

            def launch():
                _idx, _sts, _counts, gstats, _carry = sharded_scan_compact(
                    mesh, arrays, ch, None, ln, ef,
                    n_classes=auto.n_classes, capacity=DFA_CAPACITY)
                return int(gstats[0])  # matches over the shards
        return launch

    widths = sorted({nd for nd in (1, 2, 4, len(all_devices))
                     if nd <= len(all_devices)})
    kernels.hold(launcher(widths[-1]))
    rows, counts = [], set()
    for nd in widths:
        launch = launcher(nd)
        counts.add(launch())  # warm
        ms = _timing.call_ms(
            device, lambda: [launch() for _ in range(REPS)])[0] / REPS
        gbps = n_bytes / ms / 1e6
        eff = gbps / (rows[0]["gbps"] * nd) if rows else 1.0
        rows.append({"devices": nd, "gbps": gbps, "efficiency": eff})
        print(f"devices={nd}: {gbps:.3f} GB/s  efficiency={eff * 100:.0f}%",
              flush=True)
    if len(counts) != 1:
        raise RuntimeError(f"shard counts disagree over widths: {counts}")
    return {
        "engine": engine,
        "mib": mib,
        "rows": rows,
        "count": counts.pop(),
        "shards_of_one_card": one_card,
        "hash_seed": _timing.hash_seed(),
        "device": _timing.card_line(device),
        "kernels": kernels.record(),
    }


def main(argv=None) -> int:
    ap = _timing.parser(__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--mib", type=int, default=32)
    ap.add_argument(
        "--engine", choices=("dfa", "cascade"), default="dfa",
        help="dfa: sharded dense scan; cascade: the sharded sampled filter "
             "+ window-verify pass")
    a = ap.parse_args(argv)
    _timing.finish(run(a.devices, a.mib, a.engine, a.device),
                   a.artifact)
    return 0


if __name__ == "__main__":
    sys.exit(main())
