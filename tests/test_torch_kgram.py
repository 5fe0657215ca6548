"""The port's k-gram engine against the JAX package's.

The k-gram table precomposes k DFA steps into one entry (end state plus
a mid-final flag: int16 below 2^15 states, the flag in the sign bit, else
int32 with the flag in bit 30); the scan advances k bytes a gather and
flags cells, which the host re-walks.  Tables, scan outputs (before the
host's sort), expansions and records are compared exactly.
"""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import php_aho_corasick_tpu as ref  # noqa: E402
from php_aho_corasick_tpu.models import kgram_dfa as ref_kgram  # noqa: E402
from php_aho_corasick_tpu.ops import matches as ref_matches  # noqa: E402

import php_aho_corasick_tpu_torch as port  # noqa: E402
from php_aho_corasick_tpu_torch import carry  # noqa: E402
from php_aho_corasick_tpu_torch.models import kgram_dfa  # noqa: E402
from php_aho_corasick_tpu_torch.ops import matches  # noqa: E402
from test_torch_compressed import _fields  # noqa: E402
from test_torch_slice import _assert_same  # noqa: E402


def _sets():
    rng = random.Random(4)
    yield "ushers", [b"he", b"she", b"his", b"hers", b"ushers"]
    yield "abcd", sorted({bytes(rng.choice(b"abcd")
                                for _ in range(rng.randint(1, 9)))
                          for _ in range(30)})
    yield "wide", sorted({bytes(rng.choice(b"abcdefghijklmnop")
                                for _ in range(rng.randint(3, 8)))
                          for _ in range(300)})


def _autos(pats):
    """The JAX package's automaton of ``pats`` and the port's copy."""
    m = ref.Matcher([{"value": p} for p in pats])
    auto = m.automaton
    return auto, carry.automaton_from_arrays(_fields(auto))


def test_kgram_table_and_pick_k_match_jax():
    """``build_kgram_table`` for k 1-4 and ``pick_k`` over a range of
    budgets equal the JAX package's, and the models' stored tables (int16
    or int32, by state count) too."""
    for name, pats in _sets():
        auto_j, auto_t = _autos(pats)
        for k in (1, 2, 3, 4):
            if auto_t.n_states * auto_t.n_classes**k > 1 << 22:
                continue
            np.testing.assert_array_equal(
                ref_kgram.build_kgram_table(auto_j, k),
                kgram_dfa.build_kgram_table(auto_t, k), err_msg=name)
        for budget in (0, 1 << 10, 1 << 16, 1 << 20, 1 << 28, 1 << 34):
            assert (kgram_dfa.pick_k(auto_t, budget)
                    == ref_kgram.pick_k(auto_j, budget)), (name, budget)
        for int16 in (True, False):
            cj = ref.ScanConfig(allow_int16_states=int16,
                                prefer_native_builder=False)
            ct = port.ScanConfig(allow_int16_states=int16)
            want = ref_kgram.KgramDfaModel(auto_j, cj, k=2).ktable_host
            got = kgram_dfa.KgramDfaModel(auto_t, ct, "cpu", k=2).ktable_host
            assert got.dtype == want.dtype == (
                np.int16 if int16 else np.int32)
            np.testing.assert_array_equal(got, want)


def _kgram_case(pats, k, int16, seed):
    auto_j, auto_t = _autos(pats)
    cj = ref.ScanConfig(allow_int16_states=int16, prefer_native_builder=False)
    ct = port.ScanConfig(allow_int16_states=int16)
    mj = ref_kgram.KgramDfaModel(auto_j, cj, k=k)
    mt = kgram_dfa.KgramDfaModel(auto_t, ct, "cpu", k=k)
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(bytes(sorted(set(b"".join(pats)))) + b"z",
                             np.uint8)
    B, L = 6, 256
    chunks = rng.choice(alphabet, (B, L))
    lengths = np.array([L, L - 5, 129, 0, 3, 200], np.int32)
    emit_from = np.array([0, 7, 0, 0, 1, 150], np.int32)
    init = np.array([0, 1, 2, 0, 3, 1], np.int32)
    return mj, mt, chunks, lengths, emit_from, init


@pytest.mark.parametrize("int16", [True, False])
def test_scan_and_compact_kgram_matches_jax(int16):
    """``(cell_idx, prev_state, n_cells, carry)`` bit for bit, before the
    host's sort, for int16 and int32 tables, k 2 and 4, and a capacity the
    flagged cells overflow; the expansion of the cells equals the JAX
    package's too."""
    pats = dict(_sets())["abcd"]
    for k, capacity in ((2, 2048), (4, 2048), (4, 7)):
        mj, mt, chunks, lengths, emit_from, init = _kgram_case(
            pats, k, int16, k)
        assert mt.ktable_host.dtype == (np.int16 if int16 else np.int32)
        want = mj.scan_compact_device(chunks, lengths, emit_from, init,
                                      capacity)
        got = mt.scan_compact_device(chunks, lengths, emit_from,
                                     torch.from_numpy(init), capacity)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        n = int(got[2])
        assert n > 7
        if capacity < n:
            continue
        packed = ref_matches.PackedRows(
            chunks=chunks, lengths=lengths, emit_from=emit_from,
            doc_id=np.array([0, 0, 1, 2, 3, 3], np.int32),
            global_off=np.array([0, 240, 0, 0, 0, 250], np.int64))
        want_x = ref_matches.expand_matches_kgram_arrays(
            mj.auto, packed, k, np.asarray(want[0]), np.asarray(want[1]), n)
        got_x = matches.expand_matches_kgram_arrays(
            mt.auto, matches.PackedRows(**vars(packed)), k,
            got[0].numpy(), got[1].numpy(), n)
        for a, b in zip(want_x, got_x):
            np.testing.assert_array_equal(a, b)
        assert want_x[0].shape[0] > 0
        it = list(matches.expand_matches_kgram(
            mt.auto, packed, k, got[0].numpy(), got[1].numpy(), n))
        assert [(d, e, int(p[0])) for d, e, p in it] == list(
            zip(*(x.tolist() for x in got_x)))


def _kgram_matchers(pats, **extra):
    specs = [{"id": i, "value": p} for i, p in enumerate(pats)]
    cfg = dict(backend="device", auto_shard=False, chunk_len=512, **extra)
    return (ref.Matcher(specs, ref.ScanConfig(**cfg)),
            port.Matcher(specs, port.ScanConfig(**cfg), device="cpu"))


@pytest.mark.parametrize("seed", range(3))
def test_kgram_engine_matches_jax(seed):
    """A forced ``engine="kgram"`` serves the JAX Matcher's records, dict
    for dict and array for array, through capacity retries (capacity 16)
    and on a resident corpus."""
    rng = random.Random(seed)
    pats = sorted({bytes(rng.choice(b"abcd") for _ in range(rng.randint(1, 9)))
                   for _ in range(rng.randint(3, 30))})
    docs = [bytes(rng.choice(b"abcd") for _ in range(rng.randint(0, 3000)))
            for _ in range(3)]
    mj, mt = _kgram_matchers(pats, engine="kgram", match_capacity=16)
    want = mj.match_many(docs)
    assert mt.match_many(docs) == want
    assert mt.stats.last_engine == "kgram"
    assert mt.kgram_model.k == mj.kgram_model.k >= 2
    _assert_same(mj.match_arrays(docs), mt.match_arrays(docs))
    _assert_same(mj.match_arrays(docs),
                 mt.match_arrays(mt.device_corpus(docs)))
    assert sum(map(len, want)) > 16


def test_auto_route_table():
    """``auto`` on the dense table goes cascade -> tile -> k-gram (scans of
    at least ``kgram_min_bytes``, k >= 2) -> dfa, on every device; the
    records equal the JAX Matcher's, whose CPU route differs."""
    mb = 1 << 20
    cfg = dict(kgram_min_bytes=100)
    # tile-eligible: the tile engine at every size
    mj, mt = _kgram_matchers(["abc", "bc"], **cfg)
    assert mt._pick_engine(50) == mt._pick_engine(10 * mb) == "tile"
    # too big for the tile engine, no cascade (shorts): k-gram from
    # kgram_min_bytes on
    rng = random.Random(0)
    big = sorted({bytes(rng.choice(bytes(range(97, 123)))
                        for _ in range(rng.randint(2, 3)))
                  for _ in range(1500)})
    mj, mt = _kgram_matchers(big, **cfg)
    assert mt.tile_model is None and mt.kgram_model.k == 2
    assert mt._pick_engine(1000) == "kgram"
    assert mt._pick_engine(99) == "dfa"
    text = bytes(rng.choice(bytes(range(97, 123))) for _ in range(5000))
    assert mt.match(text) == mj.match(text)
    assert mt.stats.last_engine == "kgram"
    # k < 2 under the budget: the dfa at every size
    _, mt = _kgram_matchers(big, kgram_budget_bytes=1 << 10, **cfg)
    assert mt.kgram_model.k == 1 and mt._pick_engine(10 * mb) == "dfa"
    # a sampled cascade from cascade_min_bytes on, k-gram below it
    needles = sorted({bytes(rng.choice(b"abcdef") for _ in range(16))
                      for _ in range(400)})
    _, mt = _kgram_matchers(needles, **cfg)
    assert mt.cascade_model.plan.mode == "sampled" and mt.tile_model is None
    assert mt._pick_engine(mb) == "cascade"
    assert mt._pick_engine(mb - 1) == "kgram"
    assert mt._pick_engine(99) == "dfa"
