"""The port's stream scanner, ``iter_matches`` and replace engine against
the JAX package's: the same pattern specs and the same feeds give the same
record dicts (or spliced bytes), under ``backend="host"`` and
``backend="device"`` (the port on ``device="cpu"``).  Record lists and
spliced bytes are compared exactly."""

import math
import random

import pytest

torch = pytest.importorskip("torch")

import php_aho_corasick_tpu as ref  # noqa: E402

import php_aho_corasick_tpu_torch as port  # noqa: E402
from php_aho_corasick_tpu_torch import stream as port_stream  # noqa: E402

BACKENDS = ["host", "device"]


def _pair(specs, **cfg):
    cfg.setdefault("auto_shard", False)
    mj = ref.Matcher(specs, ref.ScanConfig(**cfg))
    mt = port.Matcher(specs, port.ScanConfig(**cfg), device="cpu")
    return mj, mt


def _stream(m, feeds):
    out = []
    with m.stream() as st:
        for f in feeds:
            out.extend(st.feed(f))
    return out


def _cuts(rng, n, lo, hi):
    """Feed boundaries of ``n`` bytes in random pieces of lo..hi bytes."""
    offs = [0]
    while offs[-1] < n:
        offs.append(min(n, offs[-1] + rng.randint(lo, hi)))
    return list(zip(offs, offs[1:]))


def _brute(patterns, text):
    out = []
    for p in patterns:
        start = text.find(p)
        while start != -1:
            out.append((start + len(p), -len(p), p))
            start = text.find(p, start + 1)
    out.sort()
    return [(pos, p) for pos, _, p in out]


def _pos_values(recs):
    return [(r["pos"], r["value"].encode() if isinstance(r["value"], str)
             else r["value"]) for r in recs]


# ------------------------------------------------------------- streaming


@pytest.mark.parametrize("backend", BACKENDS)
def test_stream_cross_chunk_matches_jax(backend):
    specs = [{"key": "d", "value": "defghijkl"}, {"key": "a", "value": "abcd"}]
    mj, mt = _pair(specs, backend=backend)
    feeds = ["abcde", "fghij", "klmno"]
    with mt.stream() as st:
        got = [st.feed(f) for f in feeds]
    with mj.stream() as st:
        want = [st.feed(f) for f in feeds]
    assert got == want
    assert [[r["value"] for r in g] for g in got] == [["abcd"], [],
                                                      ["defghijkl"]]
    assert got[2][0]["pos"] == 12 and got[2][0]["start_postion"] == 3


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seed", range(4))
def test_stream_equals_one_shot_and_jax(seed, backend):
    rng = random.Random(seed)
    pats = sorted({
        bytes(rng.choice(b"ab") for _ in range(rng.randint(1, 6)))
        for _ in range(10)
    })
    text = bytes(rng.choice(b"ab") for _ in range(5000))
    specs = [{"id": i, "value": p} for i, p in enumerate(pats)]
    mj, mt = _pair(specs, backend=backend)
    feeds = [text[a:b] for a, b in _cuts(rng, len(text), 1, 400)]
    got = _stream(mt, feeds)
    assert got == mt.match(text)
    assert got == _stream(mj, feeds)
    assert len(got) > 1000


@pytest.mark.parametrize("backend", BACKENDS)
def test_stream_reset_matches_jax(backend):
    seen = []
    for m in _pair(["abcd", "xy"], backend=backend):
        st = m.stream()
        assert st.feed("ab") == []
        assert st.state_depth == 2
        st.reset()
        assert (st.state, st.base_position, st.state_depth) == (0, 0, 0)
        assert st.feed("cd") == []  # no join across reset
        recs = st.feed("abcd")
        assert recs[0]["pos"] == 6
        seen.append((recs, st.state_depth, st.base_position))
        st.close()
        with pytest.raises(ValueError):
            st.feed("ab")
    assert seen[0] == seen[1]


def test_stream_device_carry_bypasses_prefix(monkeypatch):
    """Feeds above the host threshold carry the DFA state through the
    dense scan (no ``Matcher.match`` prefix re-scan) and stay exact across
    split patterns."""
    rng = random.Random(8)
    pats = [b"wxyzwxyz", b"zzzz", b"xy"]
    specs = [{"id": i, "value": p} for i, p in enumerate(pats)]
    mj, mt = _pair(specs, backend="device", host_scan_threshold=64,
                   chunk_len=512, engine="dfa")
    mt.finalize()
    monkeypatch.setattr(
        mt, "match",
        lambda *a, **k: (_ for _ in ()).throw(
            AssertionError("prefix path engaged on a device-carry feed")
        ),
    )
    text = bytearray(rng.choice(b"wxyz") for _ in range(3000))
    text[100:108] = b"wxyzwxyz"
    text[1021:1029] = b"wxyzwxyz"  # split across feeds below
    text = bytes(text)
    feeds = [text[o : o + 1025] for o in range(0, len(text), 1025)]
    got = _stream(mt, feeds)
    assert _pos_values(got) == _brute(pats, text)
    assert got == _stream(mj, feeds)


def test_stream_mixed_carry_and_prefix_paths_matches_jax():
    """Feeds alternating between the device carry (large) and the host
    prefix path (small) agree with the one-shot scan and the JAX stream."""
    rng = random.Random(9)
    pats = [b"abcabcab", b"cab"]
    specs = [{"id": i, "value": p} for i, p in enumerate(pats)]
    mj, mt = _pair(specs, backend="auto", host_scan_threshold=64,
                   chunk_len=512)
    text = bytes(rng.choice(b"abc") for _ in range(2500))
    feeds, off = [], 0
    for s in [700, 30, 900, 10, 860]:  # > and < the host threshold
        feeds.append(text[off : off + s])
        off += s
    assert off == len(text)
    got = _stream(mt, feeds)
    assert _pos_values(got) == _brute(pats, text)
    assert got == _stream(mj, feeds)


def test_stream_device_carry_compressed_table_matches_jax():
    pats = [b"mnopmnop", b"op"]
    specs = [{"id": i, "value": p} for i, p in enumerate(pats)]
    mj, mt = _pair(specs, backend="device", host_scan_threshold=16,
                   table_format="compressed", chunk_len=256)
    assert mt.table_format == "compressed"
    text = (b".." + b"mnopmnop") * 80
    feeds = [text[o : o + 301] for o in range(0, len(text), 301)]
    got = _stream(mt, feeds)
    assert _pos_values(got) == _brute(pats, text)
    assert got == _stream(mj, feeds)


# ------------------------------------------------------------- replace

REPLACE_CASES = [
    # patterns, text, replacements, mode
    (["cat", "dog"], "a cat, a dog, a catalog",
     {"cat": "tiger", "dog": "wolf"}, "normal"),
    # NORMAL: 'abcd' swallows the nested 'bc'
    (["abcd", "bc"], b"xabcdx", {b"abcd": b"[A]", b"bc": b"[B]"}, "normal"),
    # overlapping (not nested): both booked
    (["abc", "cde"], b"zabcdez", {b"abc": b"<1>", b"cde": b"<2>"}, "normal"),
    # LAZY: the first completed match wins
    (["abcd", "bc"], b"xabcdx", {b"abcd": b"[A]", b"bc": b"[B]"}, "lazy"),
    (["abcd", "bc"], b"xabcdx", {b"abcd": b"[A]", b"bc": b"[B]"}, "default"),
    (["aa", "bb"], b"aabb", {b"aa": b"X"}, "normal"),
    (["héllo"], "say héllo!", {"héllo": "goodbye"}, "normal"),
]
REPLACE_WANT = ["a tiger, a wolf, a tigeralog", b"x[A]x", b"z<1><2>z",
                b"xa[B]dx", b"x[A]x", b"Xbb", "say goodbye!"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_replace_matches_jax(backend):
    for (pats, text, rmap, mode), want in zip(REPLACE_CASES, REPLACE_WANT):
        mj, mt = _pair(pats, backend=backend)
        got = mt.replace(text, rmap, mode)
        assert got == mj.replace(text, rmap, mode)
        assert got == want and type(got) is type(text)


@pytest.mark.parametrize("backend", BACKENDS)
def test_replace_without_replaceable_patterns_raises(backend):
    for m, err in zip(_pair(["aa"], backend=backend),
                      (ref.AhoError, port.AhoError)):
        with pytest.raises(err):
            m.replace(b"aa", {b"zz": b"X"})
        with pytest.raises(err):
            m.replace_stream({b"zz": b"X"})
    with pytest.raises(ValueError):
        _pair(["aa"], backend=backend)[1].replace(b"aa", {b"aa": b"X"},
                                                  mode="greedy")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", ["normal", "lazy"])
@pytest.mark.parametrize("seed", range(2))
def test_replace_stream_equals_one_shot_and_jax(mode, seed, backend):
    rng = random.Random(seed)
    pats = [b"aba", b"bab", b"aa", b"abab"]
    rmap = {b"aba": b"<X>", b"aa": b"<Y>", b"abab": b"<LONG>"}
    text = bytes(rng.choice(b"ab") for _ in range(3000))
    specs = [{"id": i, "value": p} for i, p in enumerate(pats)]
    mj, mt = _pair(specs, backend=backend)
    want = mt.replace(text, rmap, mode)
    assert want == mj.replace(text, rmap, mode)
    cuts = _cuts(rng, len(text), 1, 250)
    for m in (mt, mj):
        rs = m.replace_stream(rmap, mode)
        out = bytearray()
        for a, b in cuts:
            out += rs.feed(text[a:b])
        out += rs.flush()
        assert bytes(out) == want


# ------------------------------------------------------- find-next iterator


@pytest.mark.parametrize("backend", BACKENDS)
def test_iter_matches_parity_with_jax(backend):
    rng = random.Random(11)
    mj, mt = _pair(["ab", "bca", "aaab", "cab"], backend=backend)
    text = "".join(rng.choice("abc") for _ in range(5000))
    got = list(mt.iter_matches(text, segment_bytes=257))
    assert got == mt.match(text)
    assert got == list(mj.iter_matches(text, segment_bytes=257))


@pytest.mark.parametrize("backend", BACKENDS)
def test_iter_matches_is_lazy(backend, monkeypatch):
    """Segment k+1 is not scanned until segment k is exhausted."""
    mj, mt = _pair(["xy"], backend=backend)
    mt.finalize()
    calls = []
    orig_feed = port_stream.StreamScanner.feed

    def spy(self, data):
        calls.append(len(data))
        return orig_feed(self, data)

    monkeypatch.setattr(port_stream.StreamScanner, "feed", spy)
    text = "xy" + "a" * 100 + "xy" + "b" * 100
    it = mt.iter_matches(text, segment_bytes=50)
    assert calls == []
    first = next(it)
    assert first["value"] == "xy" and first["pos"] == 2
    assert len(calls) == 1  # only the first segment was scanned
    rest = list(it)
    assert len(calls) == math.ceil(len(text) / 50)
    assert [r["pos"] for r in rest] == [104]
    assert [first] + rest == list(mj.iter_matches(text, segment_bytes=50))


@pytest.mark.parametrize("backend", BACKENDS)
def test_iter_matches_find_all_false(backend):
    mj, mt = _pair(["ab", "b", "abc"], backend=backend)
    text = "zzabczzabc"
    got = list(mt.iter_matches(text, find_all=False, segment_bytes=3))
    assert got == mt.match(text, find_all=False) and len(got) > 0
    assert got == list(mj.iter_matches(text, find_all=False,
                                       segment_bytes=3))


@pytest.mark.parametrize("backend", BACKENDS)
def test_iter_matches_cross_segment(backend):
    mj, mt = _pair(["abcdefgh"], backend=backend)
    text = "zz" + "abcdefgh" + "zz"
    got = list(mt.iter_matches(text, segment_bytes=5))
    assert [r["pos"] for r in got] == [10]
    assert got == list(mj.iter_matches(text, segment_bytes=5))


@pytest.mark.parametrize("backend", BACKENDS)
def test_iter_matches_empty_and_closed(backend):
    for m, err in zip(_pair(["ab"], backend=backend),
                      (ref.AhoError, port.AhoError)):
        assert list(m.iter_matches("")) == []
        m.close()
        with pytest.warns(Warning):
            with pytest.raises(err):
                m.iter_matches("ab")  # at call time, not first iteration
        for call in (m.stream, lambda: m.replace("ab", {"ab": "x"}),
                     lambda: m.replace_stream({"ab": "x"})):
            with pytest.warns(Warning), pytest.raises(err):
                call()
