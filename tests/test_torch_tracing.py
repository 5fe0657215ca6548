"""The port's own spans and wait counter (``utils/profiling.py``,
``ScanStats.host_waits``), on ``device="cpu"``: off, a span is one shared
null context and a scan records nothing; on, a scan's spans form the
tree its layers call in, share one call id, match the counter, leave the
records unchanged, and appear as ``aho:`` ranges in a profiler capture."""

import json
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import php_aho_corasick_tpu_torch as port  # noqa: E402
from php_aho_corasick_tpu_torch.parallel.mesh import local_shards  # noqa: E402
from php_aho_corasick_tpu_torch.utils import profiling  # noqa: E402

PATTERNS = [b"gammagammagam", b"aggregateagg!", b"magmamagmamag"]
KEYS = ("doc", "pos", "start_postion", "pattern")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _docs(seed, n=6, size=4000, planted=4):
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


def _matcher(**cfg):
    specs = [{"id": i, "value": p} for i, p in enumerate(PATTERNS)]
    cfg = dict(backend="device", auto_shard=False, chunk_len=512,
               engine="cascade", **cfg)
    return port.Matcher(specs, port.ScanConfig(**cfg), device="cpu")


def _warm_handles(m, seeds=(1, 2)):
    """Resident handles, each scanned once alone (as a server warms them,
    so the batched call below runs at learned capacities)."""
    hs = [m.device_corpus(_docs(s)) for s in seeds]
    for h in hs:
        m.match_arrays(h)
    return hs


def _tree(rec):
    """``(depth, name)`` of every record in opening order."""
    by_id = {r.id: r for r in rec.records}
    out = []
    for r in rec.records:
        depth, p = 0, r.parent
        while p is not None:
            depth, p = depth + 1, by_id[p].parent
        out.append((depth, r.name))
    return out


def _assert_equal(got, want):
    for k in KEYS:
        np.testing.assert_array_equal(got[k], want[k])


def test_span_off_is_one_null_context(monkeypatch):
    a = profiling.span("call", bytes=1)
    assert a is profiling.span("chain") is profiling.wait(None, 8)
    with a as inside:
        assert inside is None
    m = _matcher()
    hs = _warm_handles(m)

    def no_span(*args, **kwargs):
        raise AssertionError("a span was made with recording off")

    monkeypatch.setattr(profiling, "_Span", no_span)
    waits = m.stats.host_waits
    m.match_arrays_many(hs)
    m.match_arrays(_docs(3))
    # counted whether recording or not: 2 for the batch, 3 for the fresh
    assert m.stats.host_waits - waits == 5
    assert profiling._active is None


def test_batch_tree_and_call_ids():
    m = _matcher()
    hs = _warm_handles(m)
    with profiling.recording() as rec:
        m.match_arrays_many(hs)
    assert _tree(rec) == [
        (0, "call"),
        (1, "dispatch"),
        (2, "chain"), (3, "filter"), (3, "verify"),
        (2, "chain"), (3, "filter"), (3, "verify"),
        (1, "finish"),
        (2, "wait"), (2, "wait"), (2, "expand"), (2, "expand"),
    ]
    root = rec.records[0]
    assert root.parent is None and root.attrs == {
        "bytes": sum(h.total_bytes for h in hs), "handles": 2}
    assert {r.call for r in rec.records} == {root.call}
    for r in rec.records:
        assert r.t0 <= r.t1
    chain = next(r for r in rec.records if r.name == "chain")
    assert chain.attrs["card"] == "cpu"
    assert chain.attrs["rows"] == hs[0].packed.chunks.shape[0]
    flt = next(r for r in rec.records if r.name == "filter")
    assert flt.parent == chain.id and flt.attrs["probe_ops"] == 12
    # a second call is a new root with its own id
    with profiling.recording() as rec2:
        m.match_arrays(hs[0])
        m.match_arrays(hs[1])
    roots = [r for r in rec2.records if r.parent is None]
    assert [r.name for r in roots] == ["call", "call"]
    assert roots[0].call != roots[1].call


def test_fresh_call_packs_uploads_and_waits_three_times():
    m = _matcher()
    m.cascade_model  # built and planned before the call
    waits = m.stats.host_waits
    with profiling.recording() as rec:
        m.match_arrays(_docs(5))
    names = [r.name for r in rec.records]
    assert names == ["call", "upload", "pack", "chain", "filter", "verify",
                     "wait", "wait", "wait", "expand"]
    assert m.stats.host_waits - waits == 3
    upload = rec.records[1]
    assert upload.attrs == {"bytes": 6 * 4000, "docs": 6, "shards": 1}
    assert rec.records[2].parent == upload.id


def test_records_equal_on_and_off_and_waits_match_spans():
    m = _matcher()
    hs = _warm_handles(m)
    fresh = _docs(7)
    off = [m.match_arrays_many(hs), m.match_arrays(fresh),
           m.match_many(hs[0])]
    waits = m.stats.host_waits
    with profiling.recording() as rec:
        on = [m.match_arrays_many(hs), m.match_arrays(fresh),
              m.match_many(hs[0])]
    for got, want in zip(on[0], off[0]):
        _assert_equal(got, want)
    _assert_equal(on[1], off[1])
    assert on[2] == off[2]
    n_wait = sum(r.name == "wait" for r in rec.records)
    assert n_wait == m.stats.host_waits - waits == 2 + 3 + 3
    assert "host waits" in m.stats.summary()


def test_sharded_batch_spans_per_shard():
    """Four CPU shards: a chain a shard, the gathers to the home card,
    the stats fetch and the records fetch; records equal unsharded."""
    m = _matcher()
    docs = [_docs(1), _docs(2)]
    want = [m.match_arrays(m.device_corpus(d)) for d in docs]
    with local_shards(4):
        hs = [m.device_corpus(d, shard=True) for d in docs]
        for h in hs:
            m.match_arrays(h)
        waits = m.stats.host_waits
        with profiling.recording() as rec:
            got = m.match_arrays_many(hs)
    for g, w in zip(got, want):
        _assert_equal(g, w)
    tree = _tree(rec)
    assert tree[:2] == [(0, "call"), (1, "dispatch")]
    names = [n for _, n in tree]
    assert names.count("chain") == 8 and names.count("filter") == 8
    # per handle: counts three times, records twice; then the finish's one
    assert names.count("gather") == 2 * 5 + 1
    assert names.count("wait") == 2 == m.stats.host_waits - waits
    finish = next(r for r in rec.records if r.name == "finish")
    assert [r.name for r in rec.records if r.parent == finish.id] == [
        "wait", "wait", "expand", "expand"]
    fetch = [r for r in rec.records if r.parent == finish.id][1]
    assert [r.name for r in rec.records if r.parent == fetch.id] == [
        "gather"]


def test_stream_batches_are_calls_closed_at_each_yield():
    m = _matcher()
    hs = _warm_handles(m)
    batches = [[hs[0], hs[1]], [hs[1]], [hs[0]]]
    want = [m.match_arrays_many(b) for b in batches]
    with profiling.recording() as rec:
        got = []
        for res in m.match_arrays_stream(iter(batches)):
            assert rec._stack() == []  # no span open while the caller runs
            got.append(res)
    for gb, wb in zip(got, want):
        for g, w in zip(gb, wb):
            _assert_equal(g, w)
    roots = [r for r in rec.records if r.parent is None]
    # each batch's dispatch with the previous batch's finish, then the last
    # batch's finish alone
    assert [r.attrs["handles"] for r in roots] == [2, 1, 1, 1]
    kids = [[c.name for c in rec.records if c.parent == r.id] for r in roots]
    assert kids == [["dispatch"], ["dispatch", "finish"],
                    ["dispatch", "finish"], ["finish"]]


def test_retry_spans_after_a_coarse_overflow():
    m = _matcher()
    h = m.device_corpus(_docs(1, planted=40))
    m.match_arrays(h)
    m.cascade_model._cap_coarse = 1
    with profiling.recording() as rec:
        m.match_arrays_many([h, h])
    retries = [r for r in rec.records if r.name == "retry"]
    assert [r.attrs["stage"] for r in retries] == ["batch", "coarse",
                                                   "batch"]
    by_id = {r.id: r for r in rec.records}
    assert by_id[retries[1].parent] is retries[0]
    assert by_id[retries[0].parent].name == "finish"
    # the re-run's own chain sits under its retry, not under the dispatch
    inner = [r for r in rec.records if r.parent == retries[1].id]
    assert [r.name for r in inner] == ["chain", "wait"]


def test_build_and_plan_spans():
    with profiling.recording() as rec:
        m = _matcher()
        m.finalize()
        m.cascade_model
    names = [r.name for r in rec.records]
    assert names == ["build", "plan"]
    assert rec.records[0].attrs == {"needles": 3}


def test_profiler_ranges_follow_the_records():
    from torch.profiler import ProfilerActivity, profile

    m = _matcher()
    hs = _warm_handles(m)
    with profiling.recording() as rec, profile(
            activities=[ProfilerActivity.CPU]) as prof:
        m.match_arrays_many(hs)
        m.match_arrays(_docs(9))
    ranges = sorted(
        (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        for e in prof.profiler.kineto_results.events()
        if e.name().startswith(profiling.PREFIX)
    )
    assert [n for _, _, n in ranges] == [
        profiling.PREFIX + r.name for r in rec.records]
    by_id = {r.id: i for i, r in enumerate(rec.records)}
    for i, r in enumerate(rec.records):
        if r.parent is not None:
            p0, p1, _ = ranges[by_id[r.parent]]
            c0, c1, _ = ranges[i]
            assert p0 <= c0 and c1 <= p1, (r.name, rec.records[by_id[r.parent]])


def test_trace_shows_program_ranges(tmp_path):
    m = _matcher()
    h = m.device_corpus(_docs(1))
    with profiling.trace(str(tmp_path)) as rec:
        m.match_arrays(h)
    assert rec.records[0].name == "call"
    assert profiling._active is None
    (path,) = tmp_path.glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {"aho:call", "aho:chain", "aho:wait", "aho:expand"} <= names


def test_recording_nests_into_the_outer_block():
    with profiling.recording() as outer:
        with profiling.span("call"):
            with profiling.recording() as inner:
                with profiling.span("chain", card=torch.device("cpu")):
                    pass
    assert inner is outer
    assert [(r.name, r.parent) for r in outer.records] == [
        ("call", None), ("chain", outer.records[0].id)]
    assert outer.records[1].attrs == {"card": "cpu"}
    assert profiling._active is None


def _spy_chains(monkeypatch):
    """Every records chain's filter-hit count (a device value), as
    ``CascadeModel.launch_device_records`` returns it."""
    from php_aho_corasick_tpu_torch.models.cascade import CascadeModel

    seen = []
    real = CascadeModel.launch_device_records

    def spy(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        seen.append(out[2])
        return out

    monkeypatch.setattr(CascadeModel, "launch_device_records", spy)
    return seen


@pytest.mark.parametrize("route,cfg", [
    ("vmem", {}),
    ("grouped", {"bloom_impl": "take"}),
    ("flat", {"bloom_impl": "take", "cascade_min_q": 7}),
])
def test_filter_hits_count_the_chains_survivors(route, cfg, monkeypatch):
    """``ScanStats.filter_hits`` gains the survivors of every chain at the
    count fetches the host makes anyway (host waits unchanged: 2 a batch,
    one a lone handle's chain and two for its records), and the spans
    name the filter's route and the verify table's bytes."""
    m = _matcher(**cfg)
    hs = _warm_handles(m)
    cm = m.cascade_model
    seen = _spy_chains(monkeypatch)
    hits, waits = m.stats.filter_hits, m.stats.host_waits
    with profiling.recording() as rec:
        m.match_arrays_many(hs)
    assert len(seen) == 2 and m.stats.host_waits - waits == 2
    assert m.stats.filter_hits - hits == sum(int(n) for n in seen) > 0
    assert [r.attrs["route"] for r in rec.records
            if r.name == "filter"] == [route, route]
    if route == "vmem" and cm.records2_ok:
        table = cm.verify2_table_dev
    else:
        table = cm.dense_model.device_arrays["table_flat"]
    want = table.numel() * table.element_size()
    assert [r.attrs["table_bytes"] for r in rec.records
            if r.name == "verify"] == [want, want]
    seen.clear()
    hits, waits = m.stats.filter_hits, m.stats.host_waits
    m.match_arrays(hs[0])
    assert len(seen) == 1 and m.stats.host_waits - waits == 3
    assert m.stats.filter_hits - hits == int(seen[0]) > 0
    assert "filter hits" in m.stats.summary()


def test_filter_hits_of_sharded_batch_equal_unsharded(monkeypatch):
    m = _matcher()
    docs = [_docs(1), _docs(2)]
    hits = m.stats.filter_hits
    for d in docs:
        m.match_arrays_many([m.device_corpus(d)])
    unsharded = m.stats.filter_hits - hits
    assert unsharded > 0
    with local_shards(4):
        hs = [m.device_corpus(d, shard=True) for d in docs]
        hits = m.stats.filter_hits
        for h in hs:
            m.match_arrays(h)  # the sharded adaptive chain, a handle alone
        assert m.stats.filter_hits - hits == unsharded
        seen = _spy_chains(monkeypatch)
        hits, waits = m.stats.filter_hits, m.stats.host_waits
        m.match_arrays_many(hs)
    assert len(seen) == 8 and m.stats.host_waits - waits == 2
    assert m.stats.filter_hits - hits == sum(int(n) for n in seen)
    assert m.stats.filter_hits - hits == unsharded
