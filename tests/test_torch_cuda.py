"""The port on a CUDA card: each kernel against its plain PyTorch version
on the same CUDA tensors, and the serving path on the card against the
same path on the CPU.

These tests skip where no card is present.  The file imports no JAX, so on
a machine with a card and without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import php_aho_corasick_tpu_torch as port  # noqa: E402
from php_aho_corasick_tpu_torch.ops.filter_cuda import (  # noqa: E402
    _bank_probe_torch,
    _fused_extract_torch,
    bloom_hit,
    bloom_word_vmem,
    fused_sampled_extract,
)
from php_aho_corasick_tpu_torch.ops.filter_torch import (  # noqa: E402
    bloom_hit_take,
    u32,
)
from php_aho_corasick_tpu_torch.ops.scan_cuda import (  # noqa: E402
    _scan_states_tile_torch,
    scan_states_tile,
)

PREFIX_SALTS = (0x7F4A7C15, 0x94D049BB)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _salts(k):
    return tuple((0x9E3779B9 * (2 * i + 1)) & 0xFFFFFFFF for i in range(k))


FUSED_CASES = [
    # k, log2_rows, pack, spc, q, shorts, prefix, mpr
    (3, 12, 1, 2, 9, True, False, 16),
    (8, 12, 4, 2, 9, False, True, 24),  # the headline plan's shapes
    (8, 12, 4, 2, 9, True, True, 128),
    (2, 13, 2, 4, 9, True, True, 8),  # stride 16
    (4, 12, 1, 8, 9, False, False, 32),  # stride 32: bit 31 alignments
    (4, 13, 1, 2, 9, True, True, 16),  # 128 KiB of tables: over the budget
    (8, 13, 1, 2, 9, False, True, 24),  # 256 KiB: tables read from memory
    (5, 14, 1, 3, 16, True, True, 16),  # 320 KiB, spc 3, four words
] + [
    # every spc 1-4 x pack 1/2/4 x q 1/9/16, prefix on and off
    (3, 11, pack, spc, q, spc % 2 == 1, (spc + q + pack) % 2 == 0, 16)
    for spc in (1, 2, 3, 4) for pack in (1, 2, 4) for q in (1, 9, 16)
]


def _fused_case(cuda, k, log2_rows, pack, spc, shorts, prefix, seed):
    rng = np.random.default_rng(seed)
    n_blocks = 5
    R_pad = n_blocks * 1024
    n_banks = (1 << log2_rows) // 128
    dens = 0.5 ** (1.0 / k)
    bits = rng.random((k * n_banks // pack, 128, 32)) < dens
    table = (bits * (1 << np.arange(32, dtype=np.uint64))).sum(-1)
    table = table.astype(np.uint32).view(np.int32)
    phases = rng.integers(-(2**31), 2**31, (spc, R_pad + 8, 128),
                          dtype=np.int64).astype(np.int32)
    sw = (rng.integers(-(2**31), 2**31, (R_pad, 128), dtype=np.int64)
          * (rng.random((R_pad, 128)) < 0.01)).astype(np.int32)
    ptab = rng.integers(-(2**31), 2**31, (8, 128),
                        dtype=np.int64).astype(np.int32)

    def c(x):
        return torch.from_numpy(x).to(cuda)

    args = (c(table), c(phases), c(sw) if shorts else None,
            torch.ones((1, 1), dtype=torch.int32, device=cuda))
    kw = dict(n_grid=R_pad * 128 - 999, l16=12 if prefix else 0,
              prefix_on=prefix, prefix_table=c(ptab) if prefix else None,
              prefix_salts=PREFIX_SALTS if prefix else (),
              prefix_log2=15 if prefix else 0)
    return args, kw, n_blocks


@pytest.mark.cuda
@pytest.mark.parametrize(
    "k,log2_rows,pack,spc,q,shorts,prefix,mpr", FUSED_CASES)
def test_kernel_matches_plain(cuda, k, log2_rows, pack, spc, q, shorts,
                              prefix, mpr):
    args, kw, n_blocks = _fused_case(cuda, k, log2_rows, pack, spc, shorts,
                                     prefix, k * 100 + spc * 10 + q)
    before = fused_sampled_extract.launches
    got = fused_sampled_extract(
        *args, salts=_salts(k), log2_rows=log2_rows, pack=pack, q=q,
        spc=spc, mpr=mpr, **kw,
    )
    want = _fused_extract_torch(
        *args, _salts(k), log2_rows, pack, q, spc, mpr, 1024, n_blocks,
        kw["n_grid"], kw["l16"], kw["prefix_on"],
        prefix_table=kw["prefix_table"], prefix_salts=kw["prefix_salts"],
        prefix_log2=kw["prefix_log2"],
    )
    torch.cuda.synchronize()
    assert fused_sampled_extract.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got[4].sum()) > 0


@pytest.mark.cuda
def test_serving_path_card_equals_cpu(cuda):
    rng = random.Random(11)
    needles = sorted({bytes(rng.choice(b"abcdef") for _ in range(16))
                      for _ in range(300)})
    docs = [bytearray(rng.choice(b"abcdef") for _ in range(8192))
            for _ in range(160)]
    for _ in range(400):
        d = docs[rng.randrange(len(docs))]
        o = rng.randrange(8192 - 16)
        d[o : o + 16] = needles[rng.randrange(len(needles))]
    docs = [bytes(d) for d in docs]
    specs = [{"id": i, "value": p} for i, p in enumerate(needles)]
    cfg = port.ScanConfig(chunk_len=4096)
    res = []
    for device in (cuda, "cpu"):
        m = port.Matcher(specs, cfg, device=device)
        h = m.device_corpus(docs)
        res.append(m.match_arrays_many([h, h]))
    for a, b in zip(*res):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    assert res[0][0]["doc"].shape[0] >= 350


@pytest.mark.cuda
@pytest.mark.parametrize(
    "S,U,B,L,dtype,with_lengths",
    [
        (184, 6, 16384 // 64, 2176, np.int16, True),  # the probe set's size
        (512, 7, 300, 1000, np.int32, True),  # S*C = 4096; L % 64 != 0
        (90, 40, 129, 77, np.int16, True),  # > 32 used bytes; L % 16 != 0
        (31, 2, 5, 64, np.int32, False),  # no lengths
        (20, 3, 7, 0, np.int16, True),  # no bytes: carry = init
    ],
)
def test_tile_kernel_matches_plain(cuda, S, U, B, L, dtype, with_lengths):
    rng = np.random.default_rng(S + B)
    C = U + 1
    used = np.sort(rng.choice(256, U, replace=False)).astype(np.uint8)
    byte_class = np.zeros(256, np.int32)
    byte_class[used] = np.arange(1, U + 1)
    pool = np.concatenate([used, rng.integers(0, 256, 3)])

    def c(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(cuda)

    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[::3] = 0
    lengths[1::4] = L
    args = (c(rng.integers(0, S, S * C).astype(dtype)), c(byte_class),
            c(used), c(rng.choice(pool, (B, L)).astype(np.uint8)),
            c(rng.integers(0, S, B).astype(np.int32)), C)
    lt = c(lengths) if with_lengths else None
    before = scan_states_tile.launches
    got = scan_states_tile(*args, lengths=lt)
    want = _scan_states_tile_torch(*args, lt)
    torch.cuda.synchronize()
    assert scan_states_tile.launches == before + 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == torch.int32
        assert torch.equal(a, b)


def _ac_table(pats):
    """The port's Aho-Corasick DFA of ``pats`` (built on the CPU)."""
    m = port.Matcher([{"value": p} for p in pats],
                     port.ScanConfig(backend="device"), device="cpu")
    return m.automaton


@pytest.mark.cuda
@pytest.mark.parametrize(
    "which,B,L",
    [
        ("probe", 16384 // 16, 2176),  # the tile cell's set and row length
        ("probe", 300, 1000),  # L % 16 != 0: byte loads, short segments
        ("near4096", 200, 4000),  # S*C = 4004, a 380-byte pattern
        ("near4096", 64, 777),  # one segment a row: L < 4 * sync_len
        ("probe", 5, 0),  # no bytes: carry = init
    ],
)
def test_tile_kernel_sync_len_matches_plain(cuda, which, B, L):
    """The segmented walk (``sync_len`` = the automaton's longest pattern)
    against the plain walk on Aho-Corasick tables, with nonzero initial
    states, ragged and empty rows, and the longest pattern planted across
    segment boundaries."""
    from php_aho_corasick_tpu_torch.ops.scan_cuda import tile_segment_plan

    rng = np.random.default_rng(B + L)
    if which == "probe":
        r3 = np.random.default_rng(3)
        pats = sorted({bytes(r3.integers(97, 103, r3.integers(4, 9))
                             .astype(np.uint8)) for _ in range(40)})
        letters = np.arange(97, 103, dtype=np.uint8)
    else:
        r6 = np.random.default_rng(6)
        letters = np.arange(97, 103, dtype=np.uint8)
        pats = {r6.choice(letters, r6.integers(1, 9)).tobytes()
                for _ in range(60)}
        pats.add(r6.choice(letters, 380).tobytes())
        pats = sorted(pats)
    auto = _ac_table(pats)
    assert auto.n_states * auto.n_classes <= 4096
    longest = max(pats, key=len)
    seg_len, n_seg, _ = tile_segment_plan(L, auto.max_len)
    chunks = rng.choice(np.concatenate([letters, [0x20]]), (B, L))
    chunks = chunks.astype(np.uint8)
    for k in range(1, n_seg):
        o = k * seg_len - len(longest) + 2
        if 0 <= o <= L - len(longest):
            chunks[::2, o : o + len(longest)] = np.frombuffer(longest,
                                                              np.uint8)
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[::5] = 0
    lengths[1::3] = L

    def c(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(cuda)

    args = (c(auto.table.reshape(-1).astype(np.int32)),
            c(auto.byte_class.astype(np.int32)), c(auto.used_bytes),
            c(chunks), c(rng.integers(0, auto.n_states, B).astype(np.int32)),
            auto.n_classes)
    before = scan_states_tile.launches
    got = scan_states_tile(*args, lengths=c(lengths),
                           sync_len=auto.max_len)
    want = _scan_states_tile_torch(*args, c(lengths))
    torch.cuda.synchronize()
    assert scan_states_tile.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_tile_path_card_equals_cpu(cuda):
    rng = np.random.default_rng(3)
    pats = sorted({bytes(rng.integers(97, 103, rng.integers(4, 9))
                         .astype(np.uint8)) for _ in range(40)})
    docs = [rng.integers(97, 103, rng.integers(1, 9000), dtype=np.uint8)
            .tobytes() for _ in range(50)]
    specs = [{"id": i, "value": p} for i, p in enumerate(pats)]
    res = []
    for device in (cuda, "cpu"):
        m = port.Matcher(specs, port.ScanConfig(backend="device"),
                         device=device)
        h = m.device_corpus(docs)
        res.append((m.match_arrays(h), m.match_many(docs)))
        assert m.stats.last_engine == "tile"
    for k in res[0][0]:
        np.testing.assert_array_equal(res[0][0][k], res[1][0][k])
    assert res[0][1] == res[1][1]
    assert res[0][0]["doc"].shape[0] > 100


@pytest.mark.cuda
@pytest.mark.parametrize(
    "k,log2_rows,pack,n,offset,fill",
    [
        (7, 12, 4, 27_000_001 // 1000, 0, None),  # the rows plan, ragged n
        (2, 15, 1, 5000, 0, None),  # 256 KiB: over the shared budget, L2
        (8, 13, 2, 131_073, 0, None),
        (3, 14, 4, 1, 0, None),
        (4, 12, 1, 128 * 1024, 0, None),
        # n of 1, 3 and 4m + 1; views 1-3 elements past a 16-byte boundary
        (7, 12, 4, 1, 1, None),
        (7, 12, 4, 3, 3, None),
        (7, 12, 4, 4 * 4099 + 1, 1, None),
        (7, 12, 4, 4 * 4099 + 2, 2, None),
        (7, 12, 4, 4 * 4099 + 3, 3, None),
        (5, 14, 1, 4 * 999 + 1, 2, None),  # over the budget, misaligned
        # k = 1 and 8
        (1, 12, 4, 4 * 5000 + 1, 1, None),
        (8, 12, 4, 4 * 5000 + 1, 2, None),
        (1, 15, 2, 7777, 3, None),  # k = 1 over the budget
        # zero table: every code stops at the first probes; all ones:
        # every code takes all k probes
        (7, 12, 4, 99_999, 1, 0),
        (7, 12, 4, 99_999, 2, -1),
        (8, 12, 1, 4 * 3000 + 3, 3, -1),
        (8, 15, 4, 4 * 3000 + 1, 0, -1),  # all ones, over the budget
    ],
)
def test_bloom_word_vmem_matches_plain(cuda, k, log2_rows, pack, n, offset,
                                       fill):
    rng = np.random.default_rng(k * 1000 + log2_rows + 7 * offset)
    rows = k * ((1 << log2_rows) // 128) // pack
    table = rng.integers(-(2**31), 2**31, (rows, 128),
                         dtype=np.int64).astype(np.int32)
    if fill is not None:
        table[:] = fill
    codes = rng.integers(-(2**31), 2**31, n + offset,
                         dtype=np.int64).astype(np.int32)
    t = torch.from_numpy(table).to(cuda)
    buf = torch.from_numpy(codes).to(cuda)
    c = buf[offset:]  # a view past the buffer's 16-byte-aligned start
    assert c.data_ptr() % 16 == 4 * offset
    before = bloom_word_vmem.launches
    got = bloom_word_vmem(t, c, _salts(k), log2_rows, pack)
    want = _bank_probe_torch(t, u32(c), _salts(k), log2_rows, pack)
    torch.cuda.synchronize()
    assert bloom_word_vmem.launches == before + 1
    assert got.dtype == want.dtype == torch.int32
    assert got.data_ptr() % 16 == c.data_ptr() % 16
    assert torch.equal(got, want)
    if fill == 0:
        assert not bool(got.any())


@pytest.mark.cuda
@pytest.mark.parametrize("log2_bits,n", [(15, 1000), (17, 3_000_001),
                                         (19, 77), (20, 1 << 20)])
def test_bloom_hit_matches_plain(cuda, log2_bits, n):
    rng = np.random.default_rng(log2_bits)
    W = (1 << log2_bits) // 32
    words = rng.integers(-(2**31), 2**31, W, dtype=np.int64).astype(np.int32)
    slots = rng.integers(0, 1 << log2_bits, n).astype(np.int32)
    w, s = torch.from_numpy(words).to(cuda), torch.from_numpy(slots).to(cuda)
    before = bloom_hit.launches
    got = bloom_hit(w, s)
    want = bloom_hit_take(w, s)
    torch.cuda.synchronize()
    assert bloom_hit.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("length,alphabet", [
    (13, b"abcdef"),  # the per-row filter (stride 5)
    (7, b"abcdef"),  # anchored, bloom_hit
    (20, bytes(range(97, 123))),  # 35-byte windows: host verify
])
def test_host_verify_and_rows_paths_card_equal_cpu(cuda, length, alphabet):
    rng = np.random.default_rng(length)
    pool = np.frombuffer(alphabet, np.uint8)
    pats = sorted({rng.choice(pool, length).tobytes() for _ in range(2048)})
    docs = [bytearray(rng.choice(pool, 20_000).tobytes()) for _ in range(40)]
    for d in docs:
        for _ in range(5):
            o = int(rng.integers(0, 20_000 - length))
            d[o : o + length] = pats[int(rng.integers(0, len(pats)))]
    docs = [bytes(d) for d in docs]
    specs = [{"id": i, "value": p} for i, p in enumerate(pats)]
    cfg = port.ScanConfig(engine="cascade", chunk_len=4096)
    res = []
    for device in (cuda, "cpu"):
        m = port.Matcher(specs, cfg, device=device)
        res.append(m.match_arrays_many([m.device_corpus(docs)] * 2))
    for a, b in zip(*res):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    assert res[0][0]["doc"].shape[0] >= 150


@pytest.mark.cuda
@pytest.mark.parametrize("impl,n,branch", [
    ("take", 300, "grouped"),  # stride 8: the prefix probes on bloom_hit
    ("take", 40, "flat"),  # stride 10
    ("auto", 8192, "flat"),  # no bank bloom at the default config
])
def test_take_paths_card_equal_cpu(cuda, impl, n, branch):
    rng = random.Random(n)
    needles = sorted({bytes(rng.choice(b"abcdef") for _ in range(16))
                      for _ in range(n)})
    docs = [bytearray(rng.choice(b"abcdef") for _ in range(8192))
            for _ in range(160)]
    for _ in range(400):
        d = docs[rng.randrange(len(docs))]
        o = rng.randrange(8192 - 16)
        d[o : o + 16] = needles[rng.randrange(len(needles))]
    docs = [bytes(d) for d in docs]
    specs = [{"id": i, "value": p} for i, p in enumerate(needles)]
    cfg = port.ScanConfig(chunk_len=4096, bloom_impl=impl)
    res = []
    before = bloom_hit.launches
    for device in (cuda, "cpu"):
        m = port.Matcher(specs, cfg, device=device)
        cm = m.cascade_model
        h = m.device_corpus(docs)
        assert cm.bloom_impl() == "take"
        assert cm.take_branch(h.chunks_d.shape[1]) == branch
        res.append(m.match_arrays_many([h, h]))
        if device == cuda:
            launched = bloom_hit.launches - before
            assert launched >= 2 if branch == "grouped" else launched == 0
    for a, b in zip(*res):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    assert res[0][0]["doc"].shape[0] >= 350


@pytest.mark.cuda
def test_force_take_on_card(cuda):
    p = b"abcdefabcdefabcd"
    text = p * 70000
    m = port.Matcher([{"id": 0, "value": p}], port.ScanConfig(
        engine="cascade", cascade_mode="sampled", bloom_impl="pallas_vmem",
        chunk_len=4096), device=cuda)
    recs = m.match(text)
    assert m.cascade_model._force_take
    assert len(recs) == 70000
    assert recs[0]["pos"] == 16 and recs[-1]["pos"] == len(text)
    assert m.match(text) == recs


def _serving_case(n_docs, seed=5):
    """A cascade matcher on the card (300 needles x 16 bytes over
    ``abcdef``) and ``n_docs`` 8 KiB documents with needles planted."""
    rng = random.Random(seed)
    needles = sorted({bytes(rng.choice(b"abcdef") for _ in range(16))
                      for _ in range(300)})
    docs = [bytearray(rng.choice(b"abcdef") for _ in range(8192))
            for _ in range(n_docs)]
    for d in docs:
        for _ in range(3):
            o = rng.randrange(8192 - 16)
            d[o : o + 16] = needles[rng.randrange(len(needles))]
    return [{"id": i, "value": p} for i, p in enumerate(needles)], [
        bytes(d) for d in docs]


SLEEP_CYCLES = int(1e8)  # ~50 ms of the card's clock


def _sleepy_chains(monkeypatch):
    """Make every records chain end in ~50 ms of device sleep, then an
    event; returns the list the events go to, one a chain."""
    from php_aho_corasick_tpu_torch.models.cascade import CascadeModel

    real = CascadeModel.launch_device_records
    events = []

    def slow(self, *args, **kw):
        out = real(self, *args, **kw)
        torch.cuda._sleep(SLEEP_CYCLES)
        ev = torch.cuda.Event()
        ev.record()
        events.append(ev)
        return out

    monkeypatch.setattr(CascadeModel, "launch_device_records", slow)
    return events


def _assert_arrays_equal(got, want):
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.cuda
def test_match_arrays_stream_finish_waits_for_its_batch_only(cuda,
                                                             monkeypatch):
    """Finishing batch k returns while batch k+1's chain (dispatched before
    it) still runs: the records fetch waits for batch k's event alone."""
    specs, docs = _serving_case(40)
    m = port.Matcher(specs, port.ScanConfig(engine="cascade",
                                            chunk_len=4096), device=cuda)
    hs = [m.device_corpus(docs[i : i + 10]) for i in range(0, 40, 10)]
    batches = [[h] for h in hs]
    want = [m.match_arrays_many(b) for b in batches]
    events = _sleepy_chains(monkeypatch)
    gen = m.match_arrays_stream(iter(batches))
    got = []
    for k in range(len(batches)):
        got.append(next(gen))
        if k + 1 < len(batches):
            assert len(events) == k + 2
            assert not events[k + 1].query(), f"batch {k} waited for {k + 1}"
    assert list(gen) == []
    for g, w in zip(got, want):
        _assert_arrays_equal(g[0], w[0])
    assert sum(w[0]["doc"].shape[0] for w in want) >= 100


@pytest.mark.cuda
def test_fresh_pipeline_upload_does_not_wait_for_previous_chain(cuda,
                                                               monkeypatch):
    """In the fresh-corpus pipeline, ``device_corpus`` of slice k+1 returns
    while slice k's chain still runs, and the merged result equals one
    ``match_arrays_many`` over the whole corpus."""
    specs, docs = _serving_case(128)
    m = port.Matcher(specs, port.ScanConfig(
        engine="cascade", chunk_len=4096, fresh_slice_bytes=256 * 1024),
        device=cuda)
    want = m.match_arrays_many([m.device_corpus(docs)])[0]
    events = _sleepy_chains(monkeypatch)
    real_dc = m.device_corpus
    seen = []

    def spy(slice_docs):
        h = real_dc(slice_docs)
        seen.append((len(events), events[-1].query() if events else None))
        return h

    monkeypatch.setattr(m, "device_corpus", spy)
    got = m.match_arrays(docs)
    assert m.stats.last_engine == "cascade-fresh"
    assert [n for n, _ in seen] == [0, 1, 2, 3]
    assert [q for _, q in seen[1:]] == [False] * 3, seen
    _assert_arrays_equal(got, want)
    assert want["doc"].shape[0] >= 300


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["auto", "cascade"])
def test_stream_and_replace_card_equal_cpu(cuda, engine):
    """The stream (the dense device carry under ``auto``, the prefix
    re-scan through the cascade under ``engine="cascade"``), iter_matches
    and replace_stream on the card equal the same calls on the CPU."""
    specs, docs = _serving_case(8)
    text = b"".join(docs)
    rmap = {specs[i]["value"]: b"<%d>" % i for i in range(0, 300, 3)}
    res = []
    for device in (cuda, "cpu"):
        m = port.Matcher(specs, port.ScanConfig(engine=engine,
                                                chunk_len=4096), device=device)
        with m.stream() as st:
            recs = [r for o in range(0, len(text), 5000)
                    for r in st.feed(text[o : o + 5000])]
        assert list(m.iter_matches(text, segment_bytes=7000)) == recs
        rs = m.replace_stream(rmap)
        out = b"".join(rs.feed(text[o : o + 6000])
                       for o in range(0, len(text), 6000)) + rs.flush()
        assert out == m.replace(text, rmap)
        res.append((recs, out))
    assert res[0] == res[1]
    assert len(res[0][0]) >= 24


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [
    dict(),  # the fused filter's records chain
    dict(bloom_impl="take"),  # the grouped take filter (bloom_hit)
    dict(table_format="compressed"),
    dict(engine="dfa"),
    dict(engine="kgram"),
])
def test_sharded_card_equal_cpu(cuda, cfg):
    """Four shards of the card (``local_shards(4)``) against four shards
    of the CPU and the unsharded card: the records of the fused,
    grouped-take and compressed cascades and of the dfa and k-gram
    engines equal, and the sharded records dispatch makes no host
    sync."""
    from php_aho_corasick_tpu_torch.parallel.mesh import local_shards

    specs, docs = _serving_case(160)  # 1.25 MiB: the cascade's size
    config = port.ScanConfig(chunk_len=4096, **cfg)
    res = []
    with local_shards(4):
        for device in (cuda, "cpu"):
            m = port.Matcher(specs, config, device=device)
            h = m.device_corpus(docs, shard=True)
            assert len(h.mesh) == 4 and h.chunks_d[0].device.type == (
                torch.device(device).type)
            res.append(m.match_arrays_many([h, h]))
        m = port.Matcher(specs, config, device=cuda)
        res.append(m.match_arrays_many([m.device_corpus(docs, shard=False)]))
        cm = m.cascade_model
        if "engine" not in cfg:
            h = m.device_corpus(docs, shard=True)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                pending = m._records_batch_sharded_dispatch([h] * 2, cm)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            m._records_batch_sharded_finish(*pending, True)
    for got in res[0] + res[1]:
        _assert_arrays_equal(got, res[2][0])
    assert res[2][0]["doc"].shape[0] >= 400


@pytest.mark.cuda
@pytest.mark.parametrize("table_format", ["dense", "compressed"])
def test_load_matcher_on_card(cuda, tmp_path, table_format):
    """A matcher saved on the CPU loads onto the card (its model's tables
    there) and serves the records of the CPU matcher, through the cascade
    and the dfa engine."""
    from php_aho_corasick_tpu_torch.utils.serialization import (
        load_matcher,
        save_matcher,
    )

    specs, docs = _serving_case(160)
    config = port.ScanConfig(chunk_len=4096, table_format=table_format)
    m = port.Matcher(specs, config, device="cpu")
    save_matcher(m, tmp_path / "m.npz")
    loaded = load_matcher(tmp_path / "m.npz", config, device="cuda")
    assert loaded.device.type == "cuda" and loaded.table_format == table_format
    want = m.match_arrays(docs)
    h = loaded.device_corpus(docs)
    assert loaded._pick_engine(h.total_bytes) == "cascade"
    _assert_arrays_equal(loaded.match_arrays(h), want)
    loaded.config = port.ScanConfig(chunk_len=4096, engine="dfa")
    assert loaded._pick_engine(8 * 8192) == "dfa"
    _assert_arrays_equal(loaded.match_arrays(docs[:8]), m.match_arrays(
        docs[:8]))
    assert want["doc"].shape[0] >= 400
