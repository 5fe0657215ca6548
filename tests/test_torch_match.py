"""The port's ``match`` / ``match_many`` / ``match_arrays`` against the JAX
package's ``Matcher``: the same pattern specs and documents give the same
record dicts, in order, through the tile, dense and host engines; and the
port's engine route."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import php_aho_corasick_tpu as ref  # noqa: E402

import php_aho_corasick_tpu_torch as port  # noqa: E402
from php_aho_corasick_tpu_torch.ops.scan_cuda import (  # noqa: E402
    scan_states_tile,
)


def _specs(patterns):
    """Pattern specs in every record shape: string keys, numeric ids,
    aux values and bare values."""
    out = []
    for i, p in enumerate(patterns):
        kind = i % 4
        if kind == 0:
            out.append({"key": f"k{i}", "value": p})
        elif kind == 1:
            out.append({"id": i, "value": p, "aux": [i]})
        elif kind == 2:
            out.append({"value": p})
        else:
            out.append({"id": i, "value": p})
    return out


def _case(seed):
    """Short overlapping patterns over ``abc`` (suffix factors, a 1-byte
    pattern) and documents: empty, short, and longer than ``chunk_len``
    (halo rows)."""
    rng = random.Random(seed)
    pats = sorted({bytes(rng.choice(b"abc") for _ in range(rng.randint(2, 6)))
                   for _ in range(12)} | {b"a", b"cab"})
    docs = [b"", b"abcab"]
    docs += [bytes(rng.choice(b"abcd") for _ in range(rng.randint(50, 2500)))
             for _ in range(4)]
    return _specs(pats), docs


def _pair(specs, **cfg):
    cfg.setdefault("auto_shard", False)
    mj = ref.Matcher(specs, ref.ScanConfig(**cfg))
    mt = port.Matcher(specs, port.ScanConfig(**cfg), device="cpu")
    return mj, mt


@pytest.mark.parametrize("backend", ["device", "host"])
@pytest.mark.parametrize("engine", ["tile", "dfa", "auto"])
def test_match_many_matches_jax(engine, backend):
    specs, docs = _case(7)
    mj, mt = _pair(specs, backend=backend, engine=engine, chunk_len=512)
    for find_all in (False, True):
        want = mj.match_many(docs, find_all=find_all)
        got = mt.match_many(docs, find_all=find_all)
        assert got == want
        for a, b in zip(got, want):
            assert [list(r) for r in a] == [list(r) for r in b]
    assert sum(map(len, got)) > 100
    if backend == "device":
        assert mt.stats.last_engine == ("tile" if engine == "auto" else engine)
    else:
        assert mt.stats.last_engine == "scalar"
    # one haystack
    assert mt.match(docs[3]) == mj.match(docs[3])
    assert mt.match(docs[3], find_all=False) == mj.match(docs[3],
                                                         find_all=False)
    # columnar
    want_a = mj.match_arrays(docs)
    got_a = mt.match_arrays(docs)
    for k in want_a:
        np.testing.assert_array_equal(got_a[k], np.asarray(want_a[k]))


@pytest.mark.parametrize("engine", ["tile", "dfa"])
def test_device_corpus_handle_matches_jax(engine):
    specs, docs = _case(8)
    mj, mt = _pair(specs, backend="device", engine=engine, chunk_len=256)
    hj, ht = mj.device_corpus(docs), mt.device_corpus(docs)
    for find_all in (True, False):
        assert mt.match_many(ht, find_all=find_all) == mj.match_many(
            hj, find_all=find_all)
    want = mj.match_arrays(hj)
    for got in [mt.match_arrays(ht)] + mt.match_arrays_many([ht, ht]):
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    # the handle is off the cascade: the pipelined batch falls back, and
    # says so
    assert mt.stats.records_fallbacks == 1
    assert mt.stats.records_fallback_reason == "plan mode 'anchored'"


@pytest.mark.parametrize("engine", ["tile", "dfa"])
def test_capacity_retry_and_launch_split_match_jax(engine):
    specs, docs = _case(9)
    docs = docs + [b"a" * 3000]
    mj, mt = _pair(specs, backend="device", engine=engine, match_capacity=1,
                   max_launch_bytes=2048, chunk_len=512)
    want = mj.match_many(docs)
    got = mt.match_many(docs)
    assert got == want
    assert len(got[-1]) >= 3000
    # the same records with the default capacity in one launch
    _, big = _pair(specs, backend="device", engine=engine)
    assert big.match_many(docs) == got


def test_tile_carry_short_rows():
    """The tile engine's carry is the state after the last VALID byte of
    each row, as the dense engine's, not the pad-poisoned last column."""
    m = port.Matcher([{"id": 0, "value": b"ab"}],
                     port.ScanConfig(engine="tile"), device="cpu")
    m.finalize()
    L = 64
    chunks = np.zeros((2, L), np.uint8)
    chunks[0, :3] = np.frombuffer(b"xza", np.uint8)
    chunks[1, :5] = np.frombuffer(b"ababa", np.uint8)
    lengths = np.asarray([3, 5], np.int32)
    emit = np.zeros(2, np.int32)
    *_, carry_t = m.tile_model.scan_compact_device(
        chunks, lengths, emit, None, 16)
    *_, carry_d = m.model.scan_compact_device(chunks, lengths, emit, None, 16)
    assert torch.equal(carry_t, carry_d)
    assert int(carry_t[0]) != 0


def test_automaton_byte_class_is_compare_select():
    """On a compiled automaton, classifying through ``byte_class`` (the
    tile kernel's way) equals compare-select over ``used_bytes``."""
    from php_aho_corasick_tpu_torch.ops.scan_torch import classify_bytes

    specs, _ = _case(10)
    m = port.Matcher(specs + [{"value": "ščř"}], device="cpu")
    dev = m.tile_model.device_arrays
    every = torch.arange(256, dtype=torch.int32).to(torch.uint8)[None]
    assert torch.equal(dev["byte_class"][every.long()],
                       classify_bytes(every, dev["used_bytes"]))


def _headline_needles():
    rng = random.Random(1337)
    needles = set()
    while len(needles) < 2048:
        needles.add(bytes(rng.choice(b"abcdef") for _ in range(16)))
    return sorted(needles)


def _probe_set():
    """``benchmarks/probe_tile_tpu.py``'s small automaton: 40 draws of 4-8
    bytes over ``a-f``."""
    rng = np.random.default_rng(3)
    return sorted({
        bytes(rng.integers(97, 103, rng.integers(4, 9)).astype(np.uint8))
        for _ in range(40)
    })


def test_engine_route():
    mb = 1 << 20
    # the headline set (stride 8) takes the cascade from cascade_min_bytes
    m = port.Matcher([{"value": p} for p in _headline_needles()],
                     device="cpu")
    assert m.cascade_model.plan.stride == 8 and m.tile_model is None
    assert m._pick_engine(128 * mb) == "cascade"
    assert m._pick_engine(mb) == "cascade"
    assert m._pick_engine(mb - 1) == "dfa"
    # the probe set plans an anchored cascade, which auto never takes: the
    # tile engine serves it at every size
    m = port.Matcher([{"value": p} for p in _probe_set()], device="cpu")
    auto = m.automaton
    assert (auto.n_states, auto.n_classes) == (184, 7)
    assert m.cascade_model.plan.mode == "anchored"
    assert m._pick_engine(32 * mb) == "tile"
    assert m._pick_engine(10) == "tile"
    # forced engines
    assert port.Matcher(["ab"], port.ScanConfig(engine="kgram"),
                        device="cpu")._pick_engine(10) == "kgram"
    rng = random.Random(32)
    big = sorted({bytes(rng.choice(b"abcdefghij") for _ in range(8))
                  for _ in range(400)})
    m = port.Matcher([{"value": p} for p in big],
                     port.ScanConfig(backend="device", engine="tile"),
                     device="cpu")
    with pytest.raises(ValueError, match="tile budget"):
        m.match(b"x" * 100)
    assert port.Matcher(
        [{"value": p} for p in big], device="cpu")._pick_engine(10) == "dfa"


def test_tile_path_on_cpu_counts_no_launches():
    m = port.Matcher([{"value": p} for p in _probe_set()],
                     port.ScanConfig(backend="device"), device="cpu")
    before = scan_states_tile.launches
    text = np.random.default_rng(4).integers(97, 103, 6000, dtype=np.uint8)
    res = m.match_arrays([text.tobytes()])
    assert m.stats.last_engine == "arrays" and res["doc"].shape[0] > 0
    assert scan_states_tile.launches == before
