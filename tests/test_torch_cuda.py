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
    _grouped_extract_torch,
    _grouped_refine_torch,
    bloom_hit,
    bloom_word_vmem,
    flat_take_extract,
    fused_sampled_extract,
    grouped_take_extract,
    grouped_take_refine,
)
from php_aho_corasick_tpu_torch.ops.filter_torch import (  # noqa: E402
    _flat_extract_torch,
    _short_start_words,
    blocked_nonzero,
    bloom_hit_take,
    to_i32,
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
    return args, kw


@pytest.mark.cuda
@pytest.mark.parametrize(
    "k,log2_rows,pack,spc,q,shorts,prefix,mpr", FUSED_CASES)
def test_kernel_matches_plain(cuda, k, log2_rows, pack, spc, q, shorts,
                              prefix, mpr):
    args, kw = _fused_case(cuda, k, log2_rows, pack, spc, shorts, prefix,
                           k * 100 + spc * 10 + q)
    kw = dict(kw, salts=_salts(k), log2_rows=log2_rows, pack=pack, q=q,
              spc=spc, mpr=mpr)
    before = fused_sampled_extract.launches
    got = fused_sampled_extract(*args, **kw)
    want = _fused_extract_torch(*args, **kw)
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


def _grouped_inputs(dev, seed, B, M, stride, q, log2_words, dens, dual,
                    shorts, mll=1):
    """Random grouped-take inputs made on ``dev`` from a seeded
    generator: a packed corpus of ``B`` rows of ``M`` cells, a positional
    bloom whose words are nonzero at ``dens`` (half of them one alignment
    bit, the top one included), a second-family bloom passing half the
    slots, short words at 1% of the cells."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def ints(*shape):
        return torch.randint(-(2**31), 2**31, shape, generator=g,
                             dtype=torch.int64, device=dev).to(torch.int32)

    def where(p, x):
        u = torch.rand(x.shape, generator=g, device=dev)
        return torch.where(u < p, x, 0)

    n = 1 << log2_words
    one = torch.randint(0, stride, (n,), generator=g, device=dev)
    smask = (1 << stride) - 1
    bits = torch.where(torch.rand(n, generator=g, device=dev) < 0.5,
                       torch.ones_like(one) << one,
                       (ints(n).to(torch.int64) & smask) | 1)
    words = where(dens, to_i32(bits))
    return dict(
        words=words, wc=ints(B, M * (stride // 4)),
        sw=where(0.01, ints(B, M)) if shorts else None,
        mll=torch.tensor(mll, dtype=torch.int32, device=dev),
        words2=where(0.5, ints(n)) if dual else None,
    )


GROUPED_EXTRACT_CASES = [
    # stride, q, k, dual, shorts, block_r, mpr, B, M, log2_words, dens, mll
    (8, 9, 2, False, False, 1024, 24, 33, 256, 13, 0.02, 1),
    (12, 5, 2, True, False, 256, 8, 17, 341, 14, 0.05, 1),  # cnt > mpr
    (16, 16, 3, False, True, 128, 16, 40, 100, 12, 0.01, 1),
    (32, 9, 1, False, True, 512, 128, 9, 1000, 13, 0.3, 1),  # bit 31
    (4, 9, 2, False, False, 100, 8, 50, 64, 13, 0.05, 1),  # words past a cell
    (20, 13, 4, True, True, 1000, 40, 7, 999, 15, 0.02, 1),
    (8, 1, 8, False, True, 32, 8, 3, 77, 10, 0.1, 1),  # q 1, 8 salts
    (8, 9, 2, True, True, 1024, 24, 33, 256, 13, 0.02, 0),  # mll 0
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "stride,q,k,dual,shorts,block_r,mpr,B,M,log2_words,dens,mll",
    GROUPED_EXTRACT_CASES)
def test_grouped_take_extract_matches_plain(cuda, stride, q, k, dual, shorts,
                                            block_r, mpr, B, M, log2_words,
                                            dens, mll):
    a = _grouped_inputs(cuda, stride * q + k, B, M, stride, q, log2_words,
                        dens, dual, shorts, mll)
    kw = dict(q=q, spc=stride // 4, log2_words=log2_words, salts=_salts(k),
              mpr=mpr, block_r=block_r)
    before = grouped_take_extract.launches
    got = grouped_take_extract(a["words"], a["wc"], a["sw"], a["mll"],
                               a["words2"], **kw)
    want = _grouped_extract_torch(a["words"], a["wc"], a["sw"], a["mll"],
                                  a["words2"], **kw)
    torch.cuda.synchronize()
    assert grouped_take_extract.launches == before + 1
    for x, y in zip(got, want):
        assert x.dtype == y.dtype == torch.int32 and torch.equal(x, y)
    assert int(got[4].sum()) > 0


GROUPED_REFINE_CASES = [
    # stride, q, dual, prefix_len, n_psalts, prefix_log2, capacity
    (8, 9, False, 12, 2, 15, 4096),
    (12, 5, True, 4, 1, 17, 4096),
    (32, 9, False, 20, 2, 15, 4096),  # alignment bit 31
    (16, 16, False, 16, 2, 20, 64),  # fewer entries than hits
    (8, 9, True, 0, 0, 0, 4096),  # no prefix bloom: the gathers only
    (4, 9, False, 9, 3, 16, 1024),
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "stride,q,dual,prefix_len,n_psalts,prefix_log2,capacity",
    GROUPED_REFINE_CASES)
def test_grouped_take_refine_matches_plain(cuda, stride, q, dual, prefix_len,
                                           n_psalts, prefix_log2, capacity):
    a = _grouped_inputs(cuda, stride + prefix_len, 29, 300, stride, q, 13,
                        0.05, dual, True)
    mpr, block_r, spc = 24, 256, stride // 4
    r_s, w_s, swo_s, _, _ = _grouped_extract_torch(
        a["words"], a["wc"], a["sw"], a["mll"], a["words2"], q=q, spc=spc,
        log2_words=13, salts=_salts(2), mpr=mpr, block_r=block_r)
    slot, n = blocked_nonzero(
        ((r_s >= 0) & ((w_s | swo_s) != 0)).reshape(-1), capacity)
    pw = None
    if prefix_len:
        g = torch.Generator(device=cuda).manual_seed(prefix_log2)
        pw = torch.randint(-(2**31), 2**31, ((1 << prefix_log2) // 32,),
                           generator=g, dtype=torch.int64,
                           device=cuda).to(torch.int32)
    kw = dict(mpr=mpr, block_r=block_r, spc=spc,
              prefix_salts=(PREFIX_SALTS * 2)[:n_psalts],
              prefix_log2=prefix_log2, prefix_len=prefix_len)
    before = grouped_take_refine.launches
    got = grouped_take_refine(slot, r_s, w_s, swo_s, a["wc"], pw, **kw)
    want = _grouped_refine_torch(slot, r_s, w_s, swo_s, a["wc"], pw, **kw)
    torch.cuda.synchronize()
    assert grouped_take_refine.launches == before + 1
    for x, y in zip(got, want):
        assert x.dtype == y.dtype == torch.int32 and torch.equal(x, y)
    live = int((got[0] < 2**31 - 1).sum())
    assert 0 < live
    if prefix_len:
        assert live < min(int(n), capacity)  # the refinement dropped some


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["take-grouped", "signature-byte",
                                   "signature-hex"])
def test_grouped_take_kernels_at_path_shapes(cuda, shape):
    """Both kernels against their plain versions at the grid, bloom and
    slot shapes of the cells that run the grouped take filter: the
    headline set's 128 MiB at stride 8, and the 1M signature sets' 64 MiB
    with a 2^28-word bloom (the byte set's second code family too)."""
    stride, q, B, M, log2_words, dual, block_r, mpr, plog2 = {
        "take-grouped": (8, 9, 32768, 512, 21, False, 1024, 24, 15),
        "signature-byte": (12, 5, 16384, 342, 28, True, 256, 8, 26),
        "signature-hex": (8, 9, 16384, 512, 28, False, 512, 8, 26),
    }[shape]
    a = _grouped_inputs(cuda, log2_words, B, M, stride, q, log2_words,
                        0.01, dual, False)
    spc = stride // 4
    got = grouped_take_extract(a["words"], a["wc"], None, a["mll"],
                               a["words2"], q=q, spc=spc,
                               log2_words=log2_words, salts=_salts(2),
                               mpr=mpr, block_r=block_r)
    want = _grouped_extract_torch(a["words"], a["wc"], None, a["mll"],
                                  a["words2"], q=q, spc=spc,
                                  log2_words=log2_words, salts=_salts(2),
                                  mpr=mpr, block_r=block_r)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    r_s, w_s, swo_s, _, cnt = got
    slot, n = blocked_nonzero(
        ((r_s >= 0) & ((w_s | swo_s) != 0)).reshape(-1), 4096)
    assert int(n) > 0 and int(cnt.max()) > 0
    g = torch.Generator(device=cuda).manual_seed(plog2)
    pw = torch.randint(-(2**31), 2**31, ((1 << plog2) // 32,), generator=g,
                       dtype=torch.int64, device=cuda).to(torch.int32)
    kw = dict(mpr=mpr, block_r=block_r, spc=spc, prefix_salts=PREFIX_SALTS,
              prefix_log2=plog2, prefix_len=16)
    got = grouped_take_refine(slot, r_s, w_s, swo_s, a["wc"], pw, **kw)
    want = _grouped_refine_torch(slot, r_s, w_s, swo_s, a["wc"], pw, **kw)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def _flat_inputs(dev, seed, B, L, stride, log2_words, dens, shorts, mll,
                 offset, alphabet):
    """Random flat-take inputs made on ``dev`` from a seeded generator:
    ``[B, L]`` corpus bytes (over ``alphabet``, or any byte) viewed from
    ``offset`` bytes into their buffer, so the rows start off a 16-byte
    boundary; row lengths with a zero-length row first; a positional
    bloom whose words are nonzero at ``dens`` (the top alignment bit
    included); the short-start words of ``shorts``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    raw = torch.randint(0, 256, (offset + B * L,), generator=g,
                        dtype=torch.int64, device=dev).to(torch.uint8)
    if alphabet:
        pool = torch.tensor(list(alphabet), dtype=torch.uint8, device=dev)
        raw = pool[raw.long() % len(alphabet)]
    chunks = raw[offset:].view(B, L)
    lengths = torch.randint(0, L + 1, (B,), generator=g, device=dev,
                            dtype=torch.int32)
    lengths[0] = 0
    n = 1 << log2_words
    bits = torch.randint(0, 1 << stride, (n,), generator=g, device=dev,
                         dtype=torch.int64) | (1 << (stride - 1))
    live = torch.rand(n, generator=g, device=dev) < dens
    words = to_i32(torch.where(live, bits, 0))
    M = -(-L // stride)
    sw = (_short_start_words(chunks, lengths, shorts, stride, M)
          if shorts else None)
    return words, chunks, sw, torch.tensor(mll, dtype=torch.int32, device=dev)


FLAT_CASES = [
    # B, L, stride, q, k, shorts, mll, capacity, dens, offset, alphabet,
    # log2_words
    # the genome's class: tiles of 5,120 cells end inside rows of 704
    (40, 4224, 6, 15, 1, (), 1, 8192, 0.02, 0, b"ACGT", 16),
    (40, 4224, 6, 15, 1, (), 1, 64, 0.02, 0, b"ACGT", 16),  # capacity < hits
    # grams past the row's end, shorts, rows off 16 bytes, three salts
    (33, 1000, 7, 16, 3, (b"\x07", b"\x01\x02"), 1, 4096, 0.3, 3, None, 13),
    (17, 700, 10, 10, 8, (b"\x05",), 0, 4096, 0.5, 0, None, 12),  # mll 0
    (9, 4096, 32, 12, 2, (), 1, 2048, 0.2, 5, None, 14),  # bit 31 alignments
    (3, 5000, 1, 1, 2, (), 1, 30000, 0.1, 1, None, 10),  # tiles of 32,768
    (1, 5, 4, 9, 1, (b"\x09",), 1, 16, 0.5, 7, None, 8),  # one short row
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,L,stride,q,k,shorts,mll,capacity,dens,offset,alphabet,log2_words",
    FLAT_CASES)
def test_flat_take_extract_matches_plain(cuda, B, L, stride, q, k, shorts,
                                         mll, capacity, dens, offset,
                                         alphabet, log2_words):
    words, chunks, sw, mll_t = _flat_inputs(
        cuda, B * stride + q, B, L, stride, log2_words, dens, shorts, mll,
        offset, alphabet)
    kw = dict(q=q, stride=stride, log2_words=log2_words, salts=_salts(k),
              capacity=capacity)
    before = flat_take_extract.launches
    got = flat_take_extract(words, chunks, sw, mll_t, **kw)
    want = _flat_extract_torch(words, chunks, sw, mll_t, **kw)
    torch.cuda.synchronize()
    assert flat_take_extract.launches == before + 1
    for x, y in zip(got, want):
        assert x.dtype == y.dtype == torch.int32
        assert x.shape == y.shape and torch.equal(x, y)
    n = int(got[3])
    assert n > 0
    if capacity == 64:
        assert n > capacity


@pytest.mark.cuda
def test_flat_take_extract_raises_on_card(cuda):
    words, chunks, sw, mll = _flat_inputs(cuda, 1, 4, 64, 8, 10, 0.1, (), 1,
                                          0, None)
    kw = dict(q=9, stride=8, log2_words=10, salts=_salts(2), capacity=64)
    before = flat_take_extract.launches
    for bad in (dict(q=17), dict(salts=_salts(9)), dict(stride=33),
                dict(capacity=0)):
        with pytest.raises(ValueError):
            flat_take_extract(words, chunks, sw, mll, **dict(kw, **bad))
    with pytest.raises(TypeError):
        flat_take_extract(words.long(), chunks, sw, mll, **kw)
    with pytest.raises(ValueError):
        flat_take_extract(words, chunks.t(), sw, mll, **kw)
    assert flat_take_extract.launches == before


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
    ("take", 300, "grouped"),  # stride 8: the grouped take kernels
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
    kernels = (grouped_take_extract, grouped_take_refine, bloom_hit,
               flat_take_extract)
    before = [k.launches for k in kernels]
    for device in (cuda, "cpu"):
        m = port.Matcher(specs, cfg, device=device)
        cm = m.cascade_model
        h = m.device_corpus(docs)
        assert cm.bloom_impl() == "take"
        assert cm.take_branch(h.chunks_d.shape[1]) == branch
        res.append(m.match_arrays_many([h, h]))
        if device == cuda:
            launched = [k.launches - b for k, b in zip(kernels, before)]
            # each kernel at least once a pass (capacity retries add
            # launches), and no bloom_hit
            if branch == "grouped":
                assert launched[0] == launched[1] >= 2, launched
                assert launched[2:] == [0, 0], launched
            else:
                assert launched[:3] == [0, 0, 0], launched
                assert launched[3] >= 2, launched
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
    dict(bloom_impl="take"),  # the grouped take filter's two kernels
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
