"""Two-process ``torch.distributed`` run of the port's sharded scans.

Two OS processes, 4 CPU shards each, join one gloo group through
``parallel.mesh.init_distributed``: the mesh has 8 shards, each process
packs the same documents and keeps the row blocks of its own 4, and
every sharded branch runs with ``collect=True`` (counts and buffers
summed over the group, so both processes hold every shard's records).
Each process checks ``match_many`` against brute force for the dfa and
cascade engines, as ``tests/helpers/distributed_worker.py`` does for the
JAX package.

This file is also the worker: ``python tests/test_torch_distributed.py
HOST:PORT N_PROCS RANK`` prints ``PARITY-OK <engine>=<n>`` lines.
"""

import os
import random
import socket
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCAL_SHARDS = 4


def _workload():
    """Needles and documents with planted occurrences, identical in every
    process."""
    rng = random.Random(2024)
    patterns = sorted({
        bytes(rng.choice(b"abcdef") for _ in range(16)) for _ in range(64)
    })
    docs = []
    for _ in range(12):
        d = bytearray(rng.choice(b"abcdef") for _ in range(6000))
        for _ in range(3):
            p = rng.choice(patterns)
            pos = rng.randrange(0, len(d) - len(p))
            d[pos : pos + len(p)] = p
        docs.append(bytes(d))
    return patterns, docs


def _brute(pats, text):
    out = []
    for pidx, p in enumerate(pats):
        start = text.find(p)
        while start != -1:
            out.append((start + len(p), -len(p), pidx))
            start = text.find(p, start + 1)
    out.sort()
    return [(pos, pidx) for pos, _, pidx in out]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_sharded_scan_parity():
    pytest.importorskip("torch")
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), coordinator, "2",
             str(pid)],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed workers timed out:\n" + "\n".join(outs))
    patterns, docs = _workload()
    n_want = sum(len(_brute(patterns, d)) for d in docs)
    want = [f"PARITY-OK cascade={n_want}", f"PARITY-OK dfa={n_want}"]
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        lines = sorted(ln for ln in out.splitlines() if "PARITY-OK" in ln)
        assert lines == want, f"worker {pid} output:\n{out}"
        assert "backend=gloo shards=8 local=4" in out, out


def main(coordinator: str, n_procs: int, rank: int) -> int:
    # the worker runs the port alone: neither JAX nor the JAX package
    sys.modules["jax"] = None
    sys.modules["php_aho_corasick_tpu"] = None
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from php_aho_corasick_tpu_torch import Matcher, ScanConfig
    from php_aho_corasick_tpu_torch.parallel.mesh import (
        data_mesh, init_distributed, local_shards, process_count,
    )

    init_distributed(coordinator, n_procs, rank, backend="gloo")
    assert process_count() == n_procs, process_count()
    patterns, docs = _workload()
    want = [_brute(patterns, d) for d in docs]
    pats = [{"id": i, "value": p} for i, p in enumerate(patterns)]
    with local_shards(LOCAL_SHARDS):
        mesh = data_mesh(device="cpu")
        assert mesh.n_local == LOCAL_SHARDS, mesh
        assert mesh.first_shard == rank * LOCAL_SHARDS, mesh
        print(f"backend={dist.get_backend()} shards={len(mesh)} "
              f"local={mesh.n_local}", flush=True)
        # dense engine: sharded_scan_compact with collect=True; cascade
        # engine: the per-shard records chain
        for engine in ("dfa", "cascade"):
            cfg = ScanConfig(backend="device", engine=engine,
                             auto_shard=True, chunk_len=512,
                             match_capacity=64)
            m = Matcher(pats, cfg, device="cpu")
            res = m.match_many(docs)
            got = [[(r["pos"], r["keyIdx"]) for r in rl] for rl in res]
            assert got == want, (
                f"engine={engine} rank={rank}: mismatch "
                f"(got {sum(map(len, got))} want {sum(map(len, want))})"
            )
            print(f"PARITY-OK {engine}={sum(map(len, got))}", flush=True)
    loaded = [n for n in sys.modules
              if (n == "jax" or n.startswith("jax.")) and sys.modules[n]]
    assert not loaded, loaded
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3])))
