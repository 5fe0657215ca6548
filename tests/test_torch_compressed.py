"""The port's compressed transition table against the JAX package's.

Needle sets whose dense ``[S, C]`` table would exceed
``dense_table_max_bytes`` finalize to the compressed table (dense bank +
single-exception rows), served by the compressed DFA walk and by the
sampled cascade with the compressed window walk.  Every array compared is
an integer array and compared exactly.  Function-level cases scan one
reference-built table in both packages through
``carry.compressed_automaton_from_arrays``.  The JAX side runs jitted,
except where its op-by-op run is cheaper than XLA's compile.
"""

import dataclasses
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import php_aho_corasick_tpu as ref  # noqa: E402
from php_aho_corasick_tpu.core import automaton as ref_automaton  # noqa: E402
from php_aho_corasick_tpu.core.trie import TrieBuilder as RefTrie  # noqa: E402
from php_aho_corasick_tpu.ops import filter_jax, scan_jax  # noqa: E402

import php_aho_corasick_tpu_torch as port  # noqa: E402
from php_aho_corasick_tpu_torch import carry  # noqa: E402
from php_aho_corasick_tpu_torch.core import automaton as port_automaton  # noqa: E402
from php_aho_corasick_tpu_torch.core.trie import TrieBuilder  # noqa: E402
from php_aho_corasick_tpu_torch.ops import filter_torch, scan_torch  # noqa: E402
from test_torch_slice import _assert_same  # noqa: E402

CASES = {
    "unary-chains": [b"a" * k for k in range(1, 24)],
    "two-letter": [b"ab" * 5, b"b" * 8, b"a" * 8, b"abba", b"baab", b"bb"],
    "ushers": [b"he", b"she", b"his", b"hers", b"ushers"],
    "dup-and-reject": [b"x", b"x", b"", b"xy"],
}


def _fuzz_patterns(seed):
    rng = random.Random(seed)
    alpha = list(range(1 << rng.choice([2, 3, 8])))
    return [bytes(rng.choice(alpha) for _ in range(rng.randrange(1, 12)))
            for _ in range(rng.randrange(2, 60))]


def _compile_both(pats):
    tj, tt = RefTrie(), TrieBuilder()
    lens = []
    for p in pats:
        sj, st = tj.add(p), tt.add(p)
        assert sj.name == st.name
        if st.name == "SUCCESS":
            lens.append(len(p))
    return (ref_automaton.compile_trie_compressed(tj, lens),
            port_automaton.compile_trie_compressed(tt, lens))


def _fields(auto):
    return {f.name: getattr(auto, f.name) for f in dataclasses.fields(auto)}


@pytest.mark.parametrize(
    "case", sorted(CASES) + [f"fuzz{s}" for s in range(4)]
)
def test_compile_trie_compressed_matches_jax(case):
    pats = CASES[case] if case in CASES else _fuzz_patterns(int(case[4:]))
    want, got = _compile_both(pats)
    got.validate()
    fw, fg = _fields(want), _fields(got)
    assert fw.keys() == fg.keys()
    for name in fw:
        np.testing.assert_array_equal(np.asarray(fw[name]),
                                      np.asarray(fg[name]), err_msg=name)
        assert np.asarray(fw[name]).dtype == np.asarray(fg[name]).dtype
    assert (got.meta >= 0).all()  # the walk's % and // decode rely on it


def _ref_compressed(pats, **cfg):
    """A compressed table built by the JAX package's Matcher, and the
    port's copy of it."""
    m = ref.Matcher([{"value": p} for p in pats],
                    ref.ScanConfig(table_format="compressed", **cfg))
    auto = m.automaton
    return m, auto, carry.compressed_automaton_from_arrays(_fields(auto))


def _byte_dense_set(seed, n=120, length=(4, 12)):
    rng = np.random.default_rng(seed)
    return sorted({rng.integers(0, 256, rng.integers(*length),
                                dtype=np.uint8).tobytes() for _ in range(n)})


def _scan_args(auto, chunks, lengths, emit_from):
    meta = auto.meta if auto.meta.size else np.zeros(1, np.int32)
    tgt = auto.exc_target if auto.exc_target.size else np.zeros(1, np.int32)
    return (np.ascontiguousarray(auto.dense_table).reshape(-1), meta, tgt,
            auto.byte_class.astype(np.int32), auto.used_bytes, chunks,
            np.arange(chunks.shape[0], dtype=np.int32) % 3, lengths,
            emit_from, np.int32(auto.dense_final_start),
            np.int32(auto.final_start))


@pytest.mark.parametrize("kind,capacity", [("small-alphabet", 512),
                                           ("byte-dense", 512),
                                           ("byte-dense", 2)])
def test_scan_and_compact_compressed_matches_jax(kind,
                                                 capacity):
    """``(idx, match_state, n, carry)`` bit for bit, on the compare-select
    classes (few used bytes) and the byte-class gather (many); at capacity
    2 the count overflows and the first 2 positions are equal."""
    if kind == "small-alphabet":
        pats = list(dict.fromkeys(_fuzz_patterns(11) + [b"\x01\x02"]))
        pool = np.arange(8, dtype=np.uint8)
    else:
        pats = _byte_dense_set(3)
        pool = np.arange(256).astype(np.uint8)
    _, auto_j, auto_t = _ref_compressed(pats)
    assert (auto_t.meta >= 0).all()
    rng = np.random.default_rng(len(pats))
    B, L = 5, 192
    chunks = rng.choice(pool, (B, L))
    for r in range(B):  # plant needles
        p = np.frombuffer(pats[r * 7 % len(pats)], np.uint8)
        chunks[r, 40 : 40 + len(p)] = p
    lengths = np.array([L, L - 3, 100, 0, 77], np.int32)
    emit_from = np.array([0, 5, 0, 0, 30], np.int32)
    args = _scan_args(auto_j, chunks, lengths, emit_from)
    kw = dict(n_classes=auto_j.n_classes, n_dense=auto_j.n_dense,
              capacity=capacity)
    want = scan_jax.scan_and_compact_compressed(
        *(jnp.asarray(a) for a in args), **kw)
    got = scan_torch.scan_and_compact_compressed(
        *(torch.as_tensor(a) for a in _scan_args(auto_t, chunks, lengths,
                                                  emit_from)), **kw)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    n = int(got[2])
    assert n > (capacity if capacity < 512 else 0)


def test_verify_windows_records_compressed_matches_jax():
    """``(rec_cell, rec_pack, n_rec)`` bit for bit on one ``grid_idx``,
    with windows of more than ``VERIFY_KR`` records (the overflow
    sentinel) and a capacity the records overflow."""
    pats = [b"a", b"aa", b"aaa", b"ab", b"bab", b"abcab"]
    _, auto_j, auto_t = _ref_compressed(pats)
    rng = np.random.default_rng(9)
    stride, B, L = 4, 3, 256
    M = L // stride
    chunks = rng.choice(np.frombuffer(b"abc", np.uint8), (B, L))
    chunks[1, 80:120] = ord("a")
    lengths = np.array([L, 200, 150], np.int32)
    emit_from = np.array([0, 10, 0], np.int32)
    cells = np.sort(rng.choice(B * M, 40, replace=False)).astype(np.int32)
    cells = np.concatenate([cells, [M + 21, M + 25]]).astype(np.int32)
    grid = np.full(64, 2**31 - 1, np.int32)
    grid[: cells.shape[0]] = np.sort(np.unique(cells))
    win_len = stride - 1 + auto_j.max_len
    for capacity in (256, 7):
        kw = dict(n_classes=auto_j.n_classes, n_dense=auto_j.n_dense,
                  stride=stride, win_len=win_len, capacity=capacity,
                  n_hits=64)

        def args(auto, conv):
            a = _scan_args(auto, chunks, lengths, emit_from)
            return [conv(x) for x in a[:6] + a[7:9] + (grid,) + a[9:]]

        want = filter_jax.verify_windows_records_compressed(
            *args(auto_j, jnp.asarray), **kw)
        got = filter_torch.verify_windows_records_compressed(
            *args(auto_t, torch.as_tensor), **kw)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    n_rec = int(got[2])
    packs = got[1].numpy()
    assert n_rec > 7
    full = filter_torch.verify_windows_records_compressed(
        *args(auto_t, torch.as_tensor), **dict(kw, capacity=256))
    assert ((full[1].numpy()[: int(full[2])] & 31)
            == filter_torch.REC_OVERFLOW_J).any()
    assert packs.shape == (7,)


def _planted_docs(pats, seed, n_docs=4, size=6000, alphabet=b"abcdef"):
    rng = random.Random(seed)
    docs = []
    for _ in range(n_docs):
        d = bytearray(rng.choice(alphabet) for _ in range(size))
        for _ in range(12):
            p = rng.choice(pats)
            o = rng.randrange(0, len(d) - len(p))
            d[o : o + len(p)] = p
        docs.append(bytes(d))
    docs[0] = docs[0][:100] + b"a" * 48 + docs[0][148:]  # > VERIFY_KR
    # records in a window: the overflow sentinel and its host re-walk
    return docs


def _both(pats, **cfg):
    specs = [{"id": i, "value": p} for i, p in enumerate(pats)]
    mj = ref.Matcher(specs, ref.ScanConfig(**cfg))
    mt = port.Matcher(specs, port.ScanConfig(**cfg), device="cpu")
    return mj, mt


#: each route's config, and whether its JAX side runs op by op (cheaper
#: than XLA's compile for the take filter, dearer for the others)
ROUTES = {
    "dfa": (dict(engine="dfa"), False),
    "bank-bloom": (dict(engine="cascade", cascade_mode="sampled",
                        bloom_impl="pallas_vmem",
                        cascade_vmem_bloom_bytes=1 << 21), False),
    "take": (dict(engine="cascade", cascade_mode="sampled",
                  bloom_impl="take"), True),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_forced_compressed_matcher_matches_jax(route):
    """A forced-compressed Matcher equals the JAX one dict for dict, under
    the compressed dfa engine, the bank-bloom cascade (the records chain
    with the compressed walk) and the take cascade."""
    cfg, eager = ROUTES[route]
    with jax.disable_jit(eager):
        _forced_route(route, cfg)


def _forced_route(route, cfg):
    rng = random.Random(35)
    pats = sorted({bytes(rng.choice(b"abcdef") for _ in range(16))
                   for _ in range(40)}) + [b"a" * 16]
    docs = _planted_docs(pats, 36)
    mj, mt = _both(pats, backend="device", auto_shard=False,
                   table_format="compressed", chunk_len=512,
                   match_capacity=64, **cfg)
    assert mt.table_format == mj.table_format == "compressed"
    assert mt.automaton.n_states == mj.automaton.n_states
    if route != "dfa":
        cm = mt.cascade_model
        assert cm.records_ok and cm._compressed
        assert cm.bloom_impl() == (
            "take" if route == "take" else "pallas_vmem")
    want = mj.match_many(docs)
    assert mt.match_many(docs) == want
    assert sum(map(len, want)) > 60
    _assert_same(mj.match_arrays(docs), mt.match_arrays(docs))
    if route != "dfa":
        got = mt.match_arrays_many([mt.device_corpus(docs)])[0]
        _assert_same(mj.match_arrays(docs), got)
        assert mt.stats.records_fallbacks == 0


def test_auto_table_format_switch_matches_jax():
    """Lowering ``dense_table_max_bytes`` switches both packages to the
    compressed table: equal results, the compressed dfa below
    ``cascade_min_bytes`` and the cascade above it; the k-gram and tile
    engines are refused; the default keeps small sets dense."""
    pats = [b"hello", b"world", b"lowor", b"o w"]
    cfg = dict(backend="device", dense_table_max_bytes=64,
               cascade_min_bytes=1024)
    mj, mt = _both(pats, **cfg)
    assert mt.table_format == mj.table_format == "compressed"
    assert mt.tile_model is None
    docs = [b"say hello world " * 40, b"xhelloworldx", b""]
    assert mt.match_many(docs) == mj.match_many(docs)
    assert mt._pick_engine(16) == "dfa"
    rng = random.Random(2)
    long = sorted({bytes(rng.choice(b"abcdef") for _ in range(16))
                   for _ in range(30)})
    mj, mt = _both(long, **cfg)
    assert mt._pick_engine(1 << 20) == "cascade"
    assert mt._pick_engine(100) == "dfa"
    docs = _planted_docs(long, 3, n_docs=2)
    assert mt.match_many(docs) == mj.match_many(docs)
    for engine in ("kgram", "tile"):
        mt = port.Matcher(pats, port.ScanConfig(engine=engine, **cfg),
                          device="cpu")
        with pytest.raises(ValueError, match="dense table format"):
            mt.match(b"hello" * 1000)
    assert port.Matcher(pats, device="cpu").table_format == "dense"
