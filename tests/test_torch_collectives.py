"""The port's sharded scans and their collectives against the JAX
package's 8-device CPU mesh.

Each sharded scan gathers the shards' counts into ``counts [n_shards]``
and ``gstats = [sum, max]`` (the JAX package's ``psum`` and ``pmax``)
and stacks their buffers shard-major.  These tests hold the values
exact, the ``collect=True`` path (every process's shards, slot-masked
and summed) equal to the plain one, and every sharded scan's buffers,
counts, stats and carry equal to the JAX function's, bit for bit, also
after a capacity retry.  Mirrors ``tests/test_collectives.py``.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

import php_aho_corasick_tpu as ref  # noqa: E402
from php_aho_corasick_tpu.parallel import shard_scan as jshard  # noqa: E402
from php_aho_corasick_tpu.parallel.mesh import data_mesh as jax_mesh  # noqa: E402

import php_aho_corasick_tpu_torch as port  # noqa: E402
from php_aho_corasick_tpu_torch.parallel import shard_scan as tshard  # noqa: E402
from php_aho_corasick_tpu_torch.parallel.mesh import (  # noqa: E402
    data_mesh,
    local_shards,
)
from php_aho_corasick_tpu_torch.utils import next_pow2  # noqa: E402

N_SHARDS = 8
PATS = [{"id": 0, "value": "needle"}, {"id": 1, "value": "eed"}]


@pytest.fixture(autouse=True)
def _eight_shards():
    """The port's counterpart of the 8 virtual devices: 8 CPU shards, and
    one intra-op thread, so the port's many small ops a shard keep their
    speed when other test workers load every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with local_shards(N_SHARDS):
        yield
    torch.set_num_threads(n)


def _text(n_rows=16, L=128):
    rng = np.random.default_rng(0)
    text = rng.integers(97, 123, (n_rows, L), dtype=np.uint8)
    # different per-row match counts, so sum and max are distinguishable
    for i in range(n_rows):
        for j in range(i % 3 + 1):
            text[i, 10 + 16 * j : 16 + 16 * j] = np.frombuffer(
                b"needle", np.uint8
            )
    return text


def _rows(text):
    n_rows, L = text.shape
    return dict(
        chunks=text,
        init=np.zeros((n_rows,), np.int32),
        lengths=np.full((n_rows,), L, np.int32),
        emit_from=np.zeros((n_rows,), np.int32),
    )


def _setup(capacity=64):
    m = port.Matcher(PATS, port.ScanConfig(backend="device"), device="cpu")
    m.finalize()
    return m, data_mesh(device="cpu"), _rows(_text()), capacity


def _run(m, mesh, args, capacity, collect):
    return tshard.sharded_scan_compact(
        mesh, m.model.device_arrays, args["chunks"], args["init"],
        args["lengths"], args["emit_from"], n_classes=m.automaton.n_classes,
        capacity=capacity, collect=collect,
    )


def _jax_rows(mesh, args):
    row = NamedSharding(mesh, P("data"))
    return {k: jax.device_put(jnp.asarray(v), row) for k, v in args.items()}


def _jax_arrays(mesh, host):
    rep = NamedSharding(mesh, P())
    return {k: jax.device_put(jnp.asarray(v), rep) for k, v in host.items()}


def _same(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        a, b = np.asarray(a), b.cpu().numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b)


def test_collective_values_exact():
    m, mesh, args, cap = _setup()
    idx, sts, counts, gstats, carry = _run(m, mesh, args, cap, False)
    assert counts.shape == (N_SHARDS,) and idx.shape == (N_SHARDS, cap)
    assert int(gstats[0]) == int(counts.sum())  # the psum: global count
    assert int(gstats[1]) == int(counts.max())  # the pmax: worst occupancy
    assert int(gstats[0]) > 0
    assert carry.shape == (16,)


def test_collect_matches_sharded_buffers():
    """collect=True (each shard's slot of a zero tensor, summed over the
    processes) delivers the plain path's buffers, counts and stats."""
    m, mesh, args, cap = _setup()
    plain = _run(m, mesh, args, cap, False)
    gathered = _run(m, mesh, args, cap, True)
    for a, b in zip(plain, gathered):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("collect", [False, True])
def test_collective_counts_equal_jax(collect):
    """The gathered ``counts [n_shards]`` and ``gstats = [sum, max]``, and
    the buffers and carry beside them, equal the JAX package's psum /
    pmax / all_gather outputs exactly (dtypes included)."""
    m, mesh, args, cap = _setup()
    mj = ref.Matcher(PATS, ref.ScanConfig(backend="device"))
    mj.finalize()
    auto = mj.automaton
    jm = jax_mesh()
    assert int(jm.devices.size) == len(mesh) == N_SHARDS
    dev = _jax_arrays(jm, {
        "table_flat": np.ascontiguousarray(auto.table).reshape(-1),
        "byte_class": auto.byte_class.astype(np.int32),
        "used_bytes": auto.used_bytes,
        "final_start": np.int32(auto.final_start),
    })
    rows = _jax_rows(jm, args)
    want = jshard.sharded_scan_compact(
        jm, dev, rows["chunks"], rows["init"], rows["lengths"],
        rows["emit_from"], n_classes=auto.n_classes, capacity=cap,
        collect=collect,
    )
    _same(want, _run(m, mesh, args, cap, collect))


def test_match_many_over_mesh_uses_collectives():
    """End-to-end: the public API over the mesh returns the host scan's
    records while the retry decision reads the gathered maximum."""
    rng = np.random.default_rng(3)
    docs = [
        bytes(rng.integers(97, 123, 4000, dtype=np.uint8).tobytes())
        for _ in range(9)
    ]
    docs = [d[:100] + b"needle" + d[100:] for d in docs]
    dev = port.Matcher(PATS, port.ScanConfig(backend="device",
                                             auto_shard=True), device="cpu")
    host = port.Matcher(PATS, port.ScanConfig(backend="host"), device="cpu")
    got = dev.match_many(docs)
    assert got == [host.match(d) for d in docs]
    assert dev.stats.last_engine == "tile"


# ------------------------------------- every sharded scan against JAX

def _scan_case(engine):
    """The JAX sharded call and the port's for ``engine`` on one corpus:
    ``(run_jax(cap), run_port(cap))``."""
    pats = PATS + [{"id": 2, "value": "ab"}, {"id": 3, "value": "zz"}]
    text = _text(n_rows=16, L=256)
    args = _rows(text)
    cfg = dict(backend="device")
    if engine == "compressed":
        cfg["table_format"] = "compressed"
    mj = ref.Matcher(pats, ref.ScanConfig(**cfg))
    mt = port.Matcher(pats, port.ScanConfig(**cfg), device="cpu")
    mj.finalize()
    mt.finalize()
    auto = mj.automaton
    jm = jax_mesh()
    mesh = data_mesh(device="cpu")
    rows = _jax_rows(jm, args)
    order = ("chunks", "init", "lengths", "emit_from")
    if engine == "kgram":
        kj, kt = mj.kgram_model, mt.kgram_model
        assert kj.k == kt.k >= 2
        np.testing.assert_array_equal(kj.ktable_host, kt.ktable_host)
        host = {"ktable": kj.ktable_host,
                "byte_class": auto.byte_class.astype(np.int32),
                "used_bytes": auto.used_bytes,
                "final_start": np.int32(auto.final_start)}
        fj, ft = jshard.sharded_scan_compact_kgram, \
            tshard.sharded_scan_compact_kgram
        extra, model = dict(k=kt.k), kt
    elif engine == "compressed":
        host = {k: np.asarray(v) for k, v in mj.model.device_arrays.items()}
        fj, ft = jshard.sharded_scan_compact_compressed, \
            tshard.sharded_scan_compact_compressed
        extra, model = dict(n_dense=auto.n_dense), mt.model
    else:
        host = {"table_flat": np.ascontiguousarray(auto.table).reshape(-1),
                "byte_class": auto.byte_class.astype(np.int32),
                "used_bytes": auto.used_bytes,
                "final_start": np.int32(auto.final_start)}
        if engine == "tile":
            fj, ft = jshard.sharded_scan_compact_tile, \
                tshard.sharded_scan_compact_tile
            model = mt.tile_model
        else:
            fj, ft = jshard.sharded_scan_compact, tshard.sharded_scan_compact
            model = mt.model
        extra = {}
    dev_j = _jax_arrays(jm, host)

    def run_jax(cap):
        return fj(jm, dev_j, *(rows[k] for k in order),
                  n_classes=auto.n_classes, capacity=cap, **extra)

    def run_port(cap):
        return ft(mesh, model.device_arrays, *(args[k] for k in order),
                  n_classes=auto.n_classes, capacity=cap, **extra)

    return run_jax, run_port


@pytest.mark.parametrize("engine", ["dfa", "tile", "compressed", "kgram"])
def test_sharded_scan_matches_jax(engine):
    """Each sharded scan's buffers, counts, ``[sum, max]`` and carry equal
    the JAX function's: at a capacity the worst shard overflows, then at
    the retry's ``next_pow2`` of that shard's count."""
    run_jax, run_port = _scan_case(engine)
    cap = 4
    got = run_port(cap)
    _same(run_jax(cap), got)
    n_max = int(got[3][1])
    assert n_max > cap
    cap = next_pow2(n_max)
    got = run_port(cap)
    _same(run_jax(cap), got)
    assert int(got[3][1]) <= cap
