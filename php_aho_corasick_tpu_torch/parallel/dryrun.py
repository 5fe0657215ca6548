"""A short run of the sharded paths on an ``n``-shard mesh.

Counterpart of the JAX package's ``dryrun_multichip``
(``__graft_entry__.py``): the same three checks, on ``n_devices`` shards
of one device (``parallel.mesh.local_shards``):

1. the dense sharded scan: every row holds a planted needle, and the
   gathered ``[sum, max]`` equal the per-shard counts' sum and maximum;
2. ``sharded_sampled_verified``, the sampled filter and the
   flagged-window verify per shard: the flagged sum equals the counts;
3. the public path: ``device_corpus(docs, shard=True)`` and
   ``match_arrays_many([handle, handle])``, per-shard record chains.

Run it as ``python -m php_aho_corasick_tpu_torch.parallel.dryrun
[N_SHARDS] [DEVICE]`` (default: 4 shards of ``cuda``).
"""

from __future__ import annotations

import sys

import numpy as np


#: the JAX package's small dry-run model (``__graft_entry__.py``)
SMALL_PATTERNS = [
    {"key": "ab", "value": "alfa"},
    {"key": "ad", "value": "gamma", "aux": [1]},
    {"id": 0, "value": "zeta"},
    {"value": "lfa"},
    {"value": "he"},
    {"value": "she"},
    {"value": "hers"},
]


def dryrun_multichip(n_devices: int, device="cuda") -> str:
    """Run the three checks on ``n_devices`` shards of ``device``; raises
    on any failure (and, for ``device="cuda"``, when no card is there).
    Returns a summary line."""
    from .. import Matcher, ScanConfig
    from .mesh import data_mesh, local_shards
    from .shard_scan import sharded_sampled_verified, sharded_scan_compact

    with local_shards(n_devices):
        m = Matcher(SMALL_PATTERNS, ScanConfig(backend="device"),
                    device=device)
        auto = m.automaton
        mesh = data_mesh(device=m.device)
        assert len(mesh) == n_devices, mesh

        rng = np.random.default_rng(0)
        B, L = 4 * n_devices, 128
        text = rng.integers(0, 256, (B, L), dtype=np.uint8)
        # one needle per row, so the gathered match count is checkable
        text[:, 10:14] = np.frombuffer(b"alfa", np.uint8)
        idx, sts, counts, gstats, carry = sharded_scan_compact(
            mesh, m.model.device_arrays, text, np.zeros(B, np.int32),
            np.full(B, L, np.int32), np.zeros(B, np.int32),
            n_classes=auto.n_classes, capacity=32,
        )
        counts = counts.cpu().numpy()
        g = gstats.cpu().numpy()
        total = int(counts.sum())
        assert total >= B, f"expected >= {B} matches, got {total}"
        assert int(g[0]) == total, f"sum {g[0]} != counts sum {total}"
        assert int(g[1]) == int(counts.max()), "max mismatch"
        assert tuple(carry.shape) == (B,)
        assert tuple(idx.shape) == tuple(sts.shape) == (n_devices, 32)

        # the sampled cascade and its window verify, per shard
        rng2 = np.random.default_rng(1)
        pats16 = sorted(
            {rng2.integers(97, 103, 16, dtype=np.uint8).tobytes()
             for _ in range(32)}
        )
        mc = Matcher(
            [{"id": i, "value": p} for i, p in enumerate(pats16)],
            ScanConfig(backend="device", engine="cascade",
                       cascade_mode="sampled"),
            device=device,
        )
        mc.finalize()
        cm = mc.cascade_model
        assert cm is not None and cm.plan.mode == "sampled"
        text2 = rng2.integers(97, 103, (B, L), dtype=np.uint8)
        for i in range(B):
            text2[i, 20:36] = np.frombuffer(pats16[i % len(pats16)], np.uint8)
        cells, nfs, gh, gf, _gc = sharded_sampled_verified(
            mesh, cm, text2, np.full(B, L, np.int32), cap_hits=64,
            cap_flagged=16,
        )
        flagged = int(nfs.sum())
        assert int(gf[0]) == flagged, "sum(flagged) mismatch"
        assert flagged >= B, f"expected >= {B} flagged windows, got {flagged}"

        # the public path: a sharded handle through match_arrays_many
        assert cm.records_ok, "records gate must hold for the 16-byte set"
        docs = [text2[i].tobytes() for i in range(B)]
        handle = mc.device_corpus(docs, shard=True)
        assert handle.mesh is not None and len(handle.mesh) == n_devices
        out = mc.match_arrays_many([handle, handle])
        n_rec = int(out[0]["doc"].shape[0])
        assert n_rec >= B, f"expected >= {B} records, got {n_rec}"
        for k in out[0]:
            assert np.array_equal(out[0][k], out[1][k]), k
    return (
        f"dryrun_multichip ok: {n_devices} shards of {m.device}, {total} "
        f"dense matches + {flagged} cascade windows + {n_rec} sharded "
        "records across shards"
    )


if __name__ == "__main__":
    print(dryrun_multichip(
        int(sys.argv[1]) if len(sys.argv) > 1 else 4,
        sys.argv[2] if len(sys.argv) > 2 else "cuda",
    ))
