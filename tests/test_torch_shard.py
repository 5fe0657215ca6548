"""The port's sharded scans against the JAX package's 8-device CPU mesh.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``;
the port shards the same rows over 8 shards of the CPU
(``parallel.mesh.local_shards``).  The public entry points must give the
JAX package's records, and every sharded cascade chain its per-shard
buffers, counts and ``[sum, max]`` stats, bit for bit, also after a
capacity retry.  Mirrors ``tests/test_shard.py``.
"""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import php_aho_corasick_tpu as ref  # noqa: E402
from php_aho_corasick_tpu.parallel import shard_scan as jshard  # noqa: E402

import php_aho_corasick_tpu_torch as port  # noqa: E402
from php_aho_corasick_tpu_torch.parallel import shard_scan as tshard  # noqa: E402
from php_aho_corasick_tpu_torch.parallel.mesh import (  # noqa: E402
    data_mesh,
    local_shards,
)
from php_aho_corasick_tpu_torch.utils import next_pow2  # noqa: E402

N_SHARDS = 8


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


def brute_force(patterns, text):
    out = []
    for pid, p in enumerate(patterns):
        start = text.find(p)
        while start != -1:
            out.append((start + len(p), -len(p), pid))
            start = text.find(p, start + 1)
    out.sort()
    return [(pos, pid) for pos, _, pid in out]


def _specs(patterns):
    return [{"id": i, "value": p} for i, p in enumerate(patterns)]


def _both(patterns, **cfg):
    """The JAX package's matcher and the port's (on the CPU) on one
    config."""
    specs = _specs(patterns)
    return (ref.Matcher(specs, ref.ScanConfig(**cfg)),
            port.Matcher(specs, port.ScanConfig(**cfg), device="cpu"))


def _assert_arrays(got, want):
    for k in ("doc", "pos", "start_postion", "pattern"):
        np.testing.assert_array_equal(got[k], want[k])


def test_mesh_has_8_devices():
    assert len(jax.devices()) == N_SHARDS
    assert len(data_mesh(device="cpu")) == N_SHARDS
    mj, mt = _both([b"ab", b"ba"], backend="device")
    docs = [b"abab" * 40] * 3
    hj = mj.device_corpus(docs, shard=True)
    ht = mt.device_corpus(docs, shard=True)
    assert ht.mesh.n_shards == int(hj.mesh.devices.size) == N_SHARDS
    assert len(ht.chunks_d) == N_SHARDS
    np.testing.assert_array_equal(ht.packed.chunks, hj.packed.chunks)
    with local_shards(None):  # a CPU matcher's default mesh: one device
        assert len(data_mesh(device="cpu")) == 1
        assert mt.device_corpus(docs).mesh is None


def test_cuda_mesh_defaults_to_every_card(monkeypatch):
    """A CUDA matcher's default mesh is every visible card, its own first
    (the first device holds the gathered results); ``local_shards(n)``
    gives ``n`` shards of its card.  Only device objects are made."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    with local_shards(None):
        mesh = data_mesh(device="cuda:1")
    assert [str(d) for d in mesh.devices] == ["cuda:1", "cuda:0", "cuda:2"]
    assert mesh.home == torch.device("cuda", 1) and len(mesh) == 3
    mesh = data_mesh(device="cuda:2")
    assert mesh.devices == [torch.device("cuda", 2)] * N_SHARDS


@pytest.mark.parametrize("seed", range(4))
def test_sharded_equals_brute_force(seed):
    rng = random.Random(seed)
    alphabet = b"abc"
    patterns = list({
        bytes(rng.choice(alphabet) for _ in range(rng.randint(1, 7)))
        for _ in range(20)
    })
    docs = [
        bytes(rng.choice(alphabet) for _ in range(rng.randint(0, 4000)))
        for _ in range(12)
    ]
    mj, mt = _both(patterns, backend="device", auto_shard=True,
                   chunk_len=512, match_capacity=64)
    res = mt.match_many(docs)
    for doc, recs in zip(docs, res):
        assert [(r["pos"], r["keyIdx"]) for r in recs] == brute_force(
            patterns, doc)
    assert res == mj.match_many(docs)


def test_sharded_equals_unsharded():
    rng = random.Random(99)
    patterns = [b"abcab", b"bca", b"aa"]
    docs = [bytes(rng.choice(b"abc") for _ in range(8000)) for _ in range(5)]
    pats = _specs(patterns)
    on = port.Matcher(pats, port.ScanConfig(backend="device", auto_shard=True),
                      device="cpu")
    off = port.Matcher(pats, port.ScanConfig(backend="device",
                                             auto_shard=False), device="cpu")
    got = on.match_many(docs)
    assert got == off.match_many(docs)
    assert got == ref.Matcher(
        pats, ref.ScanConfig(backend="device", auto_shard=True)
    ).match_many(docs)


def test_sharded_capacity_retry():
    # tiny per-shard capacity; every byte matches
    cfg = port.ScanConfig(backend="device", auto_shard=True, match_capacity=2,
                          chunk_len=256)
    c = port.Matcher(["a"], cfg, device="cpu")
    res = c.match(b"a" * 5000)
    assert len(res) == 5000
    assert res[-1]["pos"] == 5000


def test_per_shard_capacity_rule():
    """Per-shard capacity shrinks with the shard count, keeps a Poisson
    imbalance margin and floors at 256, as the JAX package's rule."""
    est = 100_000
    shards = (1, 2, 4, 8, 16)
    caps = [tshard.per_shard_capacity(est, n) for n in shards]
    assert caps == sorted(caps, reverse=True)
    for n, c in zip(shards, caps):
        assert c >= 256
        assert c * n >= est  # margin: shards jointly cover the estimate
    assert tshard.per_shard_capacity(0, 8) == 256  # floor
    for e in (0, 1, 255, 4096, 10**5, 10**7):
        for n in (1, 3, 8):
            assert tshard.per_shard_capacity(e, n) == (
                jshard.per_shard_capacity(e, n))


def test_seed_caps_shard_scaled():
    rng = random.Random(5)
    patterns = sorted({
        bytes(rng.choice(b"abcdef") for _ in range(16)) for _ in range(64)
    })
    cfg = dict(backend="device", engine="cascade", auto_shard=False)

    def caps(n_shards=1, rescale=None):
        mj, mt = _both(patterns, **cfg)
        out = []
        for cm in (mj.cascade_model, mt.cascade_model):
            cm.seed_caps(100_000, 100_000, n_shards=n_shards)
            if rescale:
                cm.rescale_caps_per_shard(rescale)
                cm.rescale_caps_per_shard(rescale)  # once per shard count
            out.append((cm._cap_hits, cm._cap_flagged))
        assert out[0] == out[1]
        return out[1]

    base_hits = port.Matcher(_specs(patterns), port.ScanConfig(**cfg),
                             device="cpu").cascade_model._cap_hits
    sharded_cap = caps(8)[0]
    assert sharded_cap < caps()[0]
    assert sharded_cap >= base_hits  # never shrinks below prior learning
    caps(rescale=8)


# --------------------------------------------- sharded records fast path

def _records_workload(seed=17):
    rng = random.Random(seed)
    patterns = list({
        bytes(rng.choice(b"abcdef") for _ in range(16)) for _ in range(300)
    })
    docs = []
    for _ in range(10):
        d = bytearray(rng.choice(b"abcdef") for _ in range(4000))
        for _ in range(5):
            p = rng.choice(patterns)
            pos = rng.randrange(0, len(d) - len(p))
            d[pos : pos + len(p)] = p
        docs.append(bytes(d))
    return patterns, docs


def test_sharded_records_parity():
    """The per-shard records chain through the upload-per-call API equals
    the unsharded records path exactly."""
    patterns, docs = _records_workload()
    pats = _specs(patterns)
    m_on = port.Matcher(pats, port.ScanConfig(
        backend="device", engine="cascade", auto_shard=True, chunk_len=512),
        device="cpu")
    m_off = port.Matcher(pats, port.ScanConfig(
        backend="device", engine="cascade", auto_shard=False, chunk_len=512),
        device="cpu")
    cm = m_on.cascade_model
    assert cm is not None and cm.records_ok, cm.plan.reason
    _assert_arrays(m_on.match_arrays(docs), m_off.match_arrays(docs))


def test_sharded_device_corpus_records_batch():
    """Sharded handles through match_arrays_many equal the JAX package's
    8-device handles and the unsharded scan, also through the overflow
    retry (tiny speculative caps)."""
    patterns, docs = _records_workload(seed=23)
    mj, m = _both(patterns, backend="device", engine="cascade",
                  auto_shard=True, chunk_len=512)
    hj = mj.device_corpus(docs)
    h = m.device_corpus(docs)
    assert h.mesh is not None and hj.mesh is not None
    assert h.mesh.n_shards == int(hj.mesh.devices.size)
    expect = mj.match_arrays_many([hj])[0]
    _assert_arrays(m.match_arrays(h), expect)
    _assert_arrays(port.Matcher(_specs(patterns), port.ScanConfig(
        backend="device", engine="cascade", auto_shard=False,
        chunk_len=512), device="cpu").match_arrays(docs), expect)
    # pipelined batch, with caps forced tiny so the retry path runs (a
    # slot capacity of 1: some shard holds 2 survivors in one group)
    cm = m.cascade_model
    cm._cap_hits = 256
    cm._cap_flagged = 256
    cm._cap_coarse = 1
    for g in m.match_arrays_many([h, h]):
        _assert_arrays(g, expect)
    assert m.stats.capacity_retries > 0


def test_sharded_records_compressed():
    """Compressed-table sharded records stay exact on the mesh."""
    patterns, docs = _records_workload(seed=29)
    pats = _specs(patterns)
    m_on = port.Matcher(pats, port.ScanConfig(
        backend="device", engine="cascade", auto_shard=True, chunk_len=512,
        table_format="compressed"), device="cpu")
    cm = m_on.cascade_model
    assert cm is not None and cm._compressed and cm.records_ok
    expect = port.Matcher(pats, port.ScanConfig(
        backend="device", engine="cascade", auto_shard=False,
        chunk_len=512), device="cpu").match_arrays(docs)
    _assert_arrays(m_on.match_arrays(docs), expect)
    _assert_arrays(m_on.match_arrays_many([m_on.device_corpus(docs)])[0],
                   expect)


# ------------------------------ per-shard buffers of the cascade chains

def _same(want, got):
    """JAX outputs against the port's, bit for bit."""
    assert len(want) == len(got)
    for a, b in zip(want, got):
        a, b = np.asarray(a), b.cpu().numpy()
        assert a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _cascade_pair(patterns, docs, **cfg):
    mj, mt = _both(patterns, **dict(dict(backend="device", engine="cascade",
                                         chunk_len=512), **cfg))
    hj = mj.device_corpus(docs, shard=True)
    ht = mt.device_corpus(docs, shard=True)
    np.testing.assert_array_equal(hj.packed.chunks, ht.packed.chunks)
    cj, ct = mj.cascade_model, mt.cascade_model
    assert cj.plan.reason == ct.plan.reason
    return hj, ht, cj, ct


def _anchored_workload():
    rng = np.random.default_rng(5)
    abc = np.frombuffer(b"abcdef", np.uint8)
    pats = sorted({rng.choice(abc, 7).tobytes() for _ in range(300)})
    docs = [rng.choice(abc, 3000).tobytes() + pats[i] for i in range(6)]
    return pats, docs


def _run_candidates(retry):
    pats, docs = _anchored_workload()
    hj, ht, cj, ct = _cascade_pair(pats, docs, cascade_mode="anchored")
    assert ct.plan.mode == "anchored"
    cap = 1
    while True:
        want = jshard.sharded_filter_candidates(
            hj.mesh, cj, *hj.dev_inputs, cap)
        got = tshard.sharded_filter_candidates(
            ht.mesh, ct, *ht.dev_inputs_for(ct)[:3], cap)
        _same(want, got)
        n_max = int(got[2][1])
        if n_max <= cap:
            return n_max
        retry.append(cap)
        cap = next_pow2(n_max)


def _run_hits_sampled(retry):
    pats, docs = _records_workload()
    hj, ht, cj, ct = _cascade_pair(pats, docs, bloom_impl="take")
    cap = 4
    while True:
        want = jshard.sharded_filter_hits_sampled(
            hj.mesh, cj, hj.chunks_d, hj.lengths_d, cap)
        got = tshard.sharded_filter_hits_sampled(
            ht.mesh, ct, ht.chunks_d, ht.lengths_d, cap)
        _same(want, got)
        n_max = int(got[4][1])
        if n_max <= cap:
            return n_max
        retry.append(cap)
        cap = next_pow2(n_max)


def _run_verified(retry, impl):
    pats, docs = _records_workload(seed=31)
    hj, ht, cj, ct = _cascade_pair(pats, docs, bloom_impl=impl)
    assert ct.bloom_impl() == cj.bloom_impl() == impl
    caps = (256, 4) if impl == "take" else (256, 256)
    while True:
        want = jshard.sharded_sampled_verified(
            hj.mesh, cj, hj.chunks_d, hj.lengths_d, *caps)
        got = tshard.sharded_sampled_verified(
            ht.mesh, ct, ht.chunks_d, ht.lengths_d, *caps,
            phase_g=ht.fused_phases(ct))
        _same(want, got)
        n_max = int(got[3][1])
        if n_max <= caps[1]:
            return n_max
        retry.append(caps)
        caps = (caps[0], next_pow2(n_max))


def _run_records(retry, impl, force_take=False, **cfg):
    pats, docs = _records_workload(seed=37)
    hj, ht, cj, ct = _cascade_pair(pats, docs, bloom_impl=impl, **cfg)
    cj._force_take = ct._force_take = force_take
    caps = (2, 2) if force_take else (256, 256)
    while True:
        want = jshard.sharded_sampled_records(
            hj.mesh, cj, *hj.dev_inputs, *caps)
        got = tshard.sharded_sampled_records(
            ht.mesh, ct, *ht.dev_inputs_for(ct)[:3], *caps,
            phase_g=ht.fused_phases(ct))
        _same(want, got)
        nh, nr = int(got[3][1]), int(got[4][1])
        if nh <= caps[0] and nr <= caps[1]:
            return nr
        retry.append(caps)
        caps = (max(caps[0], next_pow2(nh)), max(caps[1], next_pow2(nr)))


CHAINS = {
    # anchored candidates (bloom_hit), with a capacity retry
    "candidates": lambda r: _run_candidates(r),
    # the flat take filter's grid hits, with a capacity retry
    "hits_sampled": lambda r: _run_hits_sampled(r),
    # flagged windows: the fused filter, and the take route with a retry
    "verified_vmem": lambda r: _run_verified(r, "pallas_vmem"),
    "verified_take": lambda r: _run_verified(r, "take"),
    # records: the fused filter, the grouped take filter, the flat take
    # filter (with a retry) and the compressed table
    "records_vmem": lambda r: _run_records(r, "pallas_vmem"),
    "records_grouped": lambda r: _run_records(r, "take"),
    "records_flat": lambda r: _run_records(r, "take", force_take=True),
    "records_compressed": lambda r: _run_records(
        r, "pallas_vmem", table_format="compressed"),
}


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_sharded_chain_buffers_match_jax(chain):
    """Per-shard buffers, counts and ``[sum, max]`` stats of each sharded
    cascade chain equal the JAX package's on its 8-device mesh; where the
    first capacity overflows, the overflowed launch and the retry on the
    worst shard's count are held too."""
    retry = []
    n_max = CHAINS[chain](retry)
    assert n_max > 0
    if chain in ("candidates", "hits_sampled", "verified_take",
                 "records_flat"):
        assert retry, "the first capacity should overflow"


def _route_case(route):
    """Needles and documents whose plan takes ``route`` through
    ``Matcher._run_sharded_cascade``."""
    rng = np.random.default_rng(11)
    abc = np.frombuffer(b"abcdef", np.uint8)
    length = {"anchored": 7, "flagged": 16, "host_verify": 24}[route]
    pats = sorted({rng.choice(abc, length).tobytes() for _ in range(200)})
    docs = [rng.choice(abc, 3000).tobytes() + pats[i] + b"xyz" * 4
            for i in range(8)]
    cfg = dict(cascade_mode="anchored") if route == "anchored" else {}
    return pats, docs, cfg


@pytest.mark.parametrize("route", ["anchored", "flagged", "host_verify"])
def test_sharded_cascade_routes_equal_unsharded(monkeypatch, route):
    """The sharded cascade's routes besides the records chain: the
    anchored candidates with host verify, the flagged-window chain (the
    records gate shut) and the flat filter with host verify (windows
    over 32 bytes) equal the unsharded scan, through the capacity retry
    (``match_capacity=2``)."""
    from php_aho_corasick_tpu_torch.models.cascade import CascadeModel

    pats, docs, cfg = _route_case(route)
    if route == "flagged":
        monkeypatch.setattr(CascadeModel, "records_ok",
                            property(lambda self: False))
    specs = _specs(pats)
    on = port.Matcher(specs, port.ScanConfig(
        backend="device", engine="cascade", chunk_len=512, match_capacity=2,
        **cfg), device="cpu")
    off = port.Matcher(specs, port.ScanConfig(
        backend="device", engine="cascade", chunk_len=512, auto_shard=False,
        **cfg), device="cpu")
    cm = on.cascade_model
    want_mode = "anchored" if route == "anchored" else "sampled"
    assert cm.plan.mode == want_mode, cm.plan.reason
    assert cm.device_verify_ok == (route == "flagged"), cm.win_len
    got = on.match_arrays(docs)
    _assert_arrays(got, off.match_arrays(docs))
    assert got["doc"].shape[0] >= len(docs)
