"""The port's native (C++) builder and oracle: bit-equal to the port's
numpy builder and to the JAX package's ``compile_trie`` on the fuzz sets
of ``tests/test_native.py``, dense and compressed; the oracle scan, the
k-gram table and the bloom scatters against their numpy forms; the
``Matcher``'s builder routing against the JAX ``Matcher``; and the
library's build (where it lives, a failed compile raising, no compiler)."""

import random
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import php_aho_corasick_tpu as ref  # noqa: E402
from php_aho_corasick_tpu.core import TrieBuilder as RefTrie  # noqa: E402
from php_aho_corasick_tpu.core import automaton as ref_automaton  # noqa: E402

import php_aho_corasick_tpu_torch as port  # noqa: E402
from php_aho_corasick_tpu_torch import native  # noqa: E402
from php_aho_corasick_tpu_torch.core import TrieBuilder, automaton  # noqa: E402
from php_aho_corasick_tpu_torch.core.tables import (  # noqa: E402
    CompressedAutomaton,
)
from php_aho_corasick_tpu_torch.models.dense_dfa import (  # noqa: E402
    DenseDfaModel,
)
from php_aho_corasick_tpu_torch.models.kgram_dfa import (  # noqa: E402
    build_kgram_table,
)

ROOT = native._DIR.parents[1]
_FIELDS = ("byte_class", "emit_start", "emit_pats", "pat_lens", "state_depth")
_DENSE = ("table",) + _FIELDS
_COMPRESSED = ("dense_table", "meta", "exc_target") + _FIELDS


@pytest.fixture(autouse=True)
def _library():
    if not native.available():
        pytest.skip("no g++ to build the native library")


def _fuzz(seed):
    """``tests/test_native.py``'s fuzz sets: random alphabets of 2-30
    bytes, 1-200 patterns of 1-12 bytes (duplicates included)."""
    rng = random.Random(1000 + seed)
    alphabet = bytes(rng.sample(range(256), rng.randint(2, 30)))
    return [
        bytes(rng.choice(alphabet) for _ in range(rng.randint(1, 12)))
        for _ in range(rng.randint(1, 200))
    ]


def _numpy_build(trie_cls, patterns, compile_fn):
    t = trie_cls(1024)
    statuses = [t.add(p) for p in patterns]
    lens = [len(p) for p, st in zip(patterns, statuses) if st == 0]
    return compile_fn(t, lens), [int(s) for s in statuses]


def _assert_same(a, b, names):
    assert (a.final_start, a.max_len, a.n_classes) == (
        b.final_start, b.max_len, b.n_classes)
    for name in names:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("fmt", ["dense", "compressed"])
@pytest.mark.parametrize("seed", range(10))
def test_native_builder_equals_numpy_and_jax(seed, fmt):
    patterns = _fuzz(seed)
    nb = native.NativeTrieBuilder(1024)
    nat_st = [int(s) for s in nb.add_batch(patterns)]
    if fmt == "dense":
        nat = nb.compile()
        fns = (automaton.compile_trie, ref_automaton.compile_trie)
        names = _DENSE
    else:
        nat = nb.compile_compressed()
        assert isinstance(nat, CompressedAutomaton)
        fns = (automaton.compile_trie_compressed,
               ref_automaton.compile_trie_compressed)
        names = _COMPRESSED
        assert nat.dense_final_start >= 0
    port_auto, port_st = _numpy_build(TrieBuilder, patterns, fns[0])
    ref_auto, ref_st = _numpy_build(RefTrie, patterns, fns[1])
    assert nat_st == port_st == ref_st
    _assert_same(nat, port_auto, names)
    _assert_same(nat, ref_auto, names)
    if fmt == "compressed":
        assert nat.dense_final_start == port_auto.dense_final_start
    nat.validate()


def test_native_statuses_and_add_batch():
    specs = [b"ab", b"ab", b"", b"x" * 2000]
    want = [port.AddStatus.SUCCESS, port.AddStatus.DUPLICATE_PATTERN,
            port.AddStatus.ZERO_PATTERN, port.AddStatus.LONG_PATTERN]
    _, st = native.build_native(specs, max_pattern_length=1024)
    assert st == want
    b = native.NativeTrieBuilder(1024)
    assert b.add_batch(specs) == want and b.add_batch([]) == []
    b.compile()
    assert b.add(b"cd") == port.AddStatus.TRIE_CLOSED
    assert b.add_batch([b"cd"]) == [port.AddStatus.TRIE_CLOSED]


@pytest.mark.parametrize("int16", [True, False])
@pytest.mark.parametrize("seed", range(5))
def test_oracle_scan_equals_scan_host(seed, int16):
    rng = random.Random(2000 + seed)
    patterns = sorted({
        bytes(rng.choice(b"abcde") for _ in range(rng.randint(1, 6)))
        for _ in range(30)
    })
    auto, _ = native.build_native(patterns, allow_int16=int16)
    assert auto.table.dtype == (np.int16 if int16 else np.int32)
    text = bytes(rng.choice(b"abcde") for _ in range(5000))
    init, emit_from = (0, 0) if seed % 2 else (3, 17)
    pos_o, st_o, carry_o = native.oracle_scan(auto, text, init, emit_from)
    data = np.frombuffer(text, dtype=np.uint8)
    port_model = DenseDfaModel(auto, port.ScanConfig(), torch.device("cpu"))
    pos_h, st_h, carry_h = port_model.scan_host(data, init, emit_from)
    np.testing.assert_array_equal(pos_o, pos_h)
    np.testing.assert_array_equal(st_o, st_h)
    assert carry_o == carry_h
    mj = ref.Matcher([{"value": p} for p in patterns],
                     ref.ScanConfig(allow_int16_states=int16))
    mj.finalize()
    pos_j, st_j, carry_j = mj.model.scan_host(data, init, emit_from)
    np.testing.assert_array_equal(pos_o, pos_j)
    np.testing.assert_array_equal(st_o, st_j)
    assert carry_o == carry_j


def test_oracle_overflow_retry():
    auto, _ = native.build_native([b"a"])
    pos, st, carry = native.oracle_scan(auto, b"a" * 100_000)
    assert pos.shape[0] == 100_000  # above the first capacity of n // 8
    np.testing.assert_array_equal(pos, np.arange(100_000))
    assert (st >= auto.final_start).all() and carry == st[-1]


@pytest.mark.parametrize("k", [2, 3, 4])
def test_kgram_build_equals_numpy(k):
    auto, _ = native.build_native([b"he", b"she", b"his", b"hers", b"s"])
    np.testing.assert_array_equal(native.kgram_build(auto, k),
                                  build_kgram_table(auto, k))


def test_scatter_or_equals_numpy():
    rng = np.random.default_rng(3)
    words = rng.integers(0, 2**32, 4096, dtype=np.uint32)
    idx = rng.integers(0, 4096, 50_000)  # many duplicates
    bits = (np.uint32(1) << rng.integers(0, 32, 50_000).astype(np.uint32))
    want = words.copy()
    np.bitwise_or.at(want, idx, bits)
    native.scatter_or(words, idx, bits)
    np.testing.assert_array_equal(words, want)
    # a scalar ``bits`` broadcasts over ``idx``
    native.scatter_or(words, idx[:10], np.uint32(1 << 31))
    np.bitwise_or.at(want, idx[:10], np.uint32(1 << 31))
    np.testing.assert_array_equal(words, want)


def test_scatter_or_bit_equals_numpy():
    rng = np.random.default_rng(4)
    words = np.zeros(1 << 12, np.uint32)
    slots = rng.integers(0, 32 << 12, 80_000)
    want = np.zeros_like(words)
    np.bitwise_or.at(want, slots >> 5,
                     np.uint32(1) << (slots & 31).astype(np.uint32))
    native.scatter_or_bit(words, slots)
    np.testing.assert_array_equal(words, want)


_SPECS = [
    {"key": "ab", "value": "alfa"},
    {"key": "ad", "value": "gamma", "aux": [1]},
    {"id": 0, "value": "zeta"},
    {"value": "lfa"},
    {"value": "alfa"},  # a duplicate: dropped, its status surfaced
    {"value": ""},
]
_HAY = "alFABETA gamma zetaomegaalfa!" * 40


@pytest.mark.parametrize("table_format", ["dense", "compressed"])
@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("prefer", [True, False])
def test_matcher_builder_routing_equals_jax(prefer, backend, table_format):
    cfg = dict(prefer_native_builder=prefer, backend=backend,
               table_format=table_format, auto_shard=False)
    mt = port.Matcher(_SPECS, port.ScanConfig(**cfg), device="cpu")
    mj = ref.Matcher(_SPECS, ref.ScanConfig(**cfg))
    want = TrieBuilder if not prefer else native.NativeTrieBuilder
    assert type(mt._trie) is want
    assert mt._statuses == mj._statuses
    assert mt.table_format == table_format
    docs = [_HAY, "", "alfa", _HAY[::-1]]
    assert mt.match_many(docs) == mj.match_many(docs)
    assert mt.match(_HAY, find_all=False) == mj.match(_HAY, find_all=False)
    got, exp = mt.match_arrays(docs), mj.match_arrays(docs)
    for key in ("doc", "pos", "start_postion", "pattern"):
        np.testing.assert_array_equal(got[key], exp[key])


def test_byte_dense_set_over_dense_limit_builds_compressed():
    """A random-byte set whose dense table would pass the limit finalizes
    to the compressed table through the native builder, bit-equal to the
    numpy builder's."""
    rng = np.random.default_rng(9)
    pats = sorted({rng.integers(0, 256, 8, dtype=np.uint8).tobytes()
                   for _ in range(600)})
    specs = [{"value": p} for p in pats]
    cfg = dict(dense_table_max_bytes=1 << 20, auto_shard=False)
    a = port.Matcher(specs, port.ScanConfig(**cfg), device="cpu")
    b = port.Matcher(specs, port.ScanConfig(prefer_native_builder=False,
                                            **cfg), device="cpu")
    assert isinstance(a._trie, native.NativeTrieBuilder)
    assert a.table_format == b.table_format == "compressed"
    _assert_same(a.automaton, b.automaton, _COMPRESSED)
    doc = bytes(rng.integers(0, 256, 4000, dtype=np.uint8)) + pats[7]
    mj = ref.Matcher(specs, ref.ScanConfig(**cfg))
    assert a.match(doc) == b.match(doc) == mj.match(doc)
    assert a.match(doc)[-1]["value"] == pats[7]


def test_library_lives_under_build_dir():
    path = native.loaded_path()
    assert path == str(native.library_path())
    assert native.library_path().parent == ROOT / "build" / "torch_kernels"
    assert native.library_path().name.startswith("libaho_native-")
    assert "php_aho_corasick_tpu/" not in path


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "CXX_FLAGS",
                        native.CXX_FLAGS + ("-include", "missing.h"))
    with pytest.raises(RuntimeError, match="missing.h"):
        native.build(tmp_path / "lib.so", shutil.which("g++"))
    assert list(tmp_path.iterdir()) == []


def test_no_compiler_falls_back_to_numpy(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_no_compiler", False)
    monkeypatch.setattr(native, "library_path", lambda: tmp_path / "x.so")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert not native.available()
    with pytest.raises(RuntimeError, match="unavailable"):
        native.NativeTrieBuilder()
    m = port.Matcher(_SPECS, device="cpu")
    assert type(m._trie) is TrieBuilder
    mj = ref.Matcher(_SPECS)
    assert m.match(_HAY) == mj.match(_HAY)
    words = np.zeros(8, np.uint32)
    native.scatter_or_bit(words, np.array([0, 33, 255]))
    native.scatter_or(words, np.array([1, 1]), np.array([4, 8], np.uint32))
    np.testing.assert_array_equal(words[:2], [1, 2 | 4 | 8])
    assert words[7] == 1 << 31
