"""The port's serving pipeline against the JAX package's: the cross-batch
double buffer (``match_arrays_stream``), the cold-corpus pipeline that
``match_arrays`` takes over a fresh document list, ``warmup``, and the
Matcher properties the stream and replace engines read.  Columnar arrays
are compared bit for bit, on ``device="cpu"``."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import php_aho_corasick_tpu as ref  # noqa: E402

import php_aho_corasick_tpu_torch as port  # noqa: E402

KEYS = ("doc", "pos", "start_postion", "pattern")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's cascade on the CPU is thousands of small torch ops; with
    one intra-op thread they keep their speed when other test workers
    load every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
PATTERNS = [b"gammagammagam", b"aggregateagg!", b"magmamagmamag"]


def _mk_docs(seed, n=6, size=4000, planted=4):
    rng = random.Random(seed)
    docs = []
    for _ in range(n):
        d = bytearray(rng.choice(b"agmert!") for _ in range(size))
        for _ in range(planted):
            p = rng.choice(PATTERNS)
            pos = rng.randrange(0, len(d) - len(p))
            d[pos : pos + len(p)] = p
        docs.append(bytes(d))
    return docs


def _pair(**cfg):
    specs = [{"id": i, "value": p} for i, p in enumerate(PATTERNS)]
    cfg = dict(backend="device", auto_shard=False, chunk_len=512, **cfg)
    mj = ref.Matcher(specs, ref.ScanConfig(**cfg))
    mt = port.Matcher(specs, port.ScanConfig(**cfg), device="cpu")
    return mj, mt


def _assert_arrays(got, want):
    for k in KEYS:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype, k


def _assert_batches(got, want):
    assert len(got) == len(want)
    for gl, wl in zip(got, want):
        assert len(gl) == len(wl)
        for g, w in zip(gl, wl):
            _assert_arrays(g, w)


@pytest.mark.parametrize("engine,fallback", [("cascade", False),
                                             ("auto", True)])
def test_match_arrays_stream_matches_jax(engine, fallback):
    """``match_arrays_stream`` yields per-batch ``match_arrays_many``, equal
    to the JAX package's stream.  With ``engine="auto"`` a one-document
    handle routes off the cascade, so its batches fall back."""
    cfg = dict(engine=engine)
    if fallback:
        cfg["cascade_min_bytes"] = 16 * 1024
    mj, mt = _pair(**cfg)
    docs = [_mk_docs(41), _mk_docs(42)] + ([_mk_docs(43, n=1)]
                                          if fallback else [])
    out = []
    for m in (mt, mj):
        hs = [m.device_corpus(d) for d in docs]
        if fallback:
            batches = [[hs[0], hs[1]], [hs[2]], [hs[0], hs[2]], [hs[1]]]
        else:
            batches = [[hs[0], hs[1]], [hs[1]], [hs[0], hs[0], hs[1]]]
        got = list(m.match_arrays_stream(iter(batches)))
        _assert_batches(got, [m.match_arrays_many(b) for b in batches])
        out.append(got)
    _assert_batches(*out)
    assert sum(r["doc"].shape[0] for b in out[0] for r in b) > 40
    if fallback:
        assert mt._pick_engine(len(docs[2][0])) != "cascade"
        assert mt.stats.records_fallbacks == mj.stats.records_fallbacks > 0
    else:
        assert mt.stats.records_fallbacks == 0


def test_records_batch_dispatch_has_no_event_on_cpu():
    """On the CPU the batch's counts stay a tensor and no event is made;
    the finish reads them as they are."""
    _, mt = _pair(engine="cascade")
    h = mt.device_corpus(_mk_docs(41))
    pending = mt._records_batch_dispatch([h, h], mt.cascade_model)
    counts, ready = pending[-2:]
    assert ready is None and counts.shape == (6,)
    got = mt._records_batch_finish(*pending, True)
    _assert_batches([got], [mt.match_arrays_many([h, h])])


def test_records_batch_finish_decides_overflow_once():
    """Both handles of a batch overflow the coarse slot capacity; handle
    0's re-run grows the learned capacity past handle 1's count, and
    handle 1 must still re-run rather than read records that were never
    fetched.  Each handle's records equal ``match_arrays``'."""
    _, mt = _pair(engine="cascade")
    hs = [mt.device_corpus(_mk_docs(s, planted=40)) for s in (1, 2)]
    want = [mt.match_arrays(h) for h in hs]
    cm = mt.cascade_model
    nc = mt._records_batch_dispatch(hs, cm)[-2].reshape(2, 3)[:, 2]
    assert int(nc.min()) > 1  # both overflow a capacity of 1
    cm._cap_coarse = 1
    retries = mt.stats.capacity_retries
    got = mt.match_arrays_many(hs)
    assert mt.stats.capacity_retries == retries + 1
    assert cm._cap_coarse >= int(nc[1])
    for g, w in zip(got, want):
        _assert_arrays(g, w)


def test_fresh_pipeline_matches_grouped_and_jax():
    """A fresh document list over ``2 * fresh_slice_bytes`` goes through
    the pipeline (doc indices made global across slices), equal to the
    grouped path and to the JAX package's pipeline, also with
    ``find_all=False``."""
    rng = random.Random(71)
    docs = []
    for _ in range(40):
        d = bytearray(rng.choice(b"agmert!") for _ in range(3000))
        for _ in range(2):
            p = rng.choice(PATTERNS)
            pos = rng.randrange(0, len(d) - len(p))
            d[pos : pos + len(p)] = p
        docs.append(bytes(d))
    mj, mt = _pair(engine="cascade", fresh_slice_bytes=16 * 1024)
    _, grouped = _pair(engine="cascade")  # default slice: pipeline off
    for find_all in (True, False):
        got = mt.match_arrays(docs, find_all=find_all)
        assert mt.stats.last_engine == "cascade-fresh"
        want = grouped.match_arrays(docs, find_all=find_all)
        assert grouped.stats.last_engine == "arrays"
        _assert_arrays(got, want)
        _assert_arrays(got, mj.match_arrays(docs, find_all=find_all))
        assert mj.stats.last_engine == "cascade-fresh"
    assert np.unique(got["doc"]).shape[0] == 40
    # one slice's worth of documents keeps the grouped path
    few = mt.match_arrays(docs[:5])
    assert mt.stats.last_engine == "arrays"
    _assert_arrays(few, grouped.match_arrays(docs[:5]))


def test_warmup_matches_jax():
    mj, mt = _pair(engine="auto")
    for m in (mj, mt):
        m.warmup(2000, 3)
        m.warmup()
    for key in ("scans", "bytes_scanned", "matches_emitted"):
        assert getattr(mt.stats, key) == getattr(mj.stats, key), key
    assert mt.stats.bytes_scanned == 3 * 2000 + 512
    assert mt.stats.last_backend == "cpu"  # the device, not the host scan
    # the port takes the card's route on every device; the reference takes
    # its tile engine on a TPU only
    assert (mt.stats.last_engine, mj.stats.last_engine) == ("tile", "dfa")


def test_matcher_properties_match_jax():
    specs = [{"key": "a", "value": "alfa"}, {"value": "lfa"}, "lfa", ""]
    mj = ref.Matcher(specs)
    mt = port.Matcher(specs, device="cpu")
    for m in (mj, mt):
        assert not m.finalized
    assert mt.n_patterns == mj.n_patterns == 2
    assert mt.describe() == mj.describe() == "Matcher(open, 2 patterns)"
    for m in (mj, mt):
        m.finalize()
        assert m.finalized
    assert mt.describe() == mj.describe()
    assert "states" in mt.describe()
    comp = [
        pkg.Matcher([b"mnopmnop", b"op"],
                    pkg.ScanConfig(table_format="compressed"), **kw)
        for pkg, kw in ((ref, {}), (port, {"device": "cpu"}))
    ]
    for m in comp:
        m.finalize()
    assert comp[1].describe() == comp[0].describe()
    assert comp[1].describe().startswith("CompressedAutomaton")
