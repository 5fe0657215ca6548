"""The port's per-row sampled filter against the JAX package's.

Plans whose stride is no multiple of 4 (or does not divide the row) cannot
take the fused filter; both packages then run the per-row filter: gram
codes at the grid points, the salted bank-bloom probe (``bloom_word_vmem``),
a rank extraction per 128-lane row and a fine re-probe.  Every comparison
here is exact: codes, words, slot indices and counts bit for bit, match
records dict for dict.  The JAX side runs as its own CPU tests run it: the
Pallas kernel in interpret mode, its filters op by op under
``jax.disable_jit()`` where XLA's compile of the unrolled extraction costs
more than the work.
"""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import php_aho_corasick_tpu as ref  # noqa: E402
from php_aho_corasick_tpu.ops import filter_jax, filter_pallas  # noqa: E402

import php_aho_corasick_tpu_torch as port  # noqa: E402
from php_aho_corasick_tpu_torch.ops import filter_torch  # noqa: E402
from php_aho_corasick_tpu_torch.ops.filter_cuda import (  # noqa: E402
    _out_like,
    bloom_word_vmem,
)
from php_aho_corasick_tpu_torch.ops.filter_torch import KNUTH  # noqa: E402
from test_torch_slice import _assert_same  # noqa: E402


def _salts(k):
    return tuple((0x9E3779B9 * (2 * i + 1)) & 0xFFFFFFFF for i in range(k))


def _i32(rng, shape):
    return rng.integers(-(2**31), 2**31, shape, dtype=np.int64).astype(np.int32)


def _table(rng, k, log2_rows, pack, bit_density):
    """Random bank tables ``[k * n_banks / pack, 128]`` with each bit set
    at ``bit_density``."""
    rows = k * ((1 << log2_rows) // 128) // pack
    bits = rng.random((rows, 128, 32)) < bit_density
    words = (bits * (1 << np.arange(32, dtype=np.uint64))).sum(-1)
    return words.astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("q,stride,L", [(9, 5, 77), (8, 3, 100), (9, 7, 64),
                                        (16, 20, 1010), (4, 5, 3)])
def test_sampled_gram_codes_match_jax(q, stride, L):
    rng = np.random.default_rng(q * 100 + stride)
    chunks = rng.integers(0, 256, (3, L), dtype=np.int64).astype(np.uint8)
    want = np.asarray(filter_jax.sampled_gram_codes(jnp.asarray(chunks), q,
                                                    stride))
    got = filter_torch.sampled_gram_codes(torch.from_numpy(chunks), q, stride)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("pack", [1, 2, 4])
def test_bloom_word_vmem_plain_matches_pallas(pack):
    """The plain version (what the wrapper runs on a CPU tensor) against
    the Pallas kernel body in interpret mode."""
    rng = np.random.default_rng(pack)
    k, log2_rows = 3, 11
    table = _i32(rng, (k * (1 << log2_rows) // 128 // pack, 128))
    codes = _i32(rng, (7, 531))  # ragged: not a multiple of 128
    want = filter_pallas.bloom_word_vmem(
        jnp.asarray(table), jnp.asarray(codes), _salts(k), log2_rows,
        pack=pack, interpret=True, force_pallas=True, block_r=8,
    )
    before = bloom_word_vmem.launches
    got = bloom_word_vmem(torch.from_numpy(table), torch.from_numpy(codes),
                          _salts(k), log2_rows, pack)
    assert got.dtype == torch.int32 and got.shape == codes.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bloom_word_vmem.launches == before  # CPU tensors launch nothing


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_bloom_word_vmem_output_shares_the_codes_offset(offset):
    """The wrapper's output (``_out_like``) lies at the codes' offset
    within 16 bytes, so the kernel's 16-byte loads and stores split codes
    and words at the same elements: views 0-3 elements past a 16-byte
    boundary, ragged and 2-D shapes."""
    buf = torch.zeros(4 * 64 + 16, dtype=torch.int32)
    start = (-buf.data_ptr() % 16) // 4 + offset
    for shape in [(1,), (3,), (4 * 7 + 1,), (5, 13)]:
        n = int(np.prod(shape))
        codes = buf[start : start + n].view(shape)
        out = _out_like(codes)
        assert out.data_ptr() % 16 == codes.data_ptr() % 16 == 4 * offset
        assert out.shape == codes.shape and out.dtype == torch.int32
        assert out.is_contiguous()


@pytest.mark.parametrize("pack", [1, 2, 4])
def test_bloom_word_vmem_staged_layout_equals_plain_probe(pack):
    """A numpy model of the kernel's shared-memory table: sub-word ``j``
    of table word ``s`` staged at entry ``(s & ~127) * pack + 128 j +
    (s & 127)`` (salt ``p``'s bloom row ``r`` at ``(p << log2_rows) +
    r``), probed at the funnel shift ``(p : h) >> (32 - log2_rows)`` of
    ``h = (code ^ salt_p) * 2654435761``.  Its AND over the salts equals
    the plain probe."""
    rng = np.random.default_rng(10 + pack)
    k, log2_rows = 3, 11
    sw = 32 // pack
    # each bit set after the AND at 0.7 / sw: about half the codes hit
    table = _table(rng, k, log2_rows, pack, (0.7 / sw) ** (1.0 / k))
    words = table.reshape(-1).view(np.uint32).astype(np.uint64)
    s = np.arange(words.size, dtype=np.uint64)
    entries = np.zeros(k << log2_rows, np.uint64)
    for j in range(pack):
        e = (s & ~np.uint64(127)) * pack + 128 * j + (s & 127)
        entries[e] = (words >> (sw * j)) & ((1 << sw) - 1)
    codes = _i32(rng, 5000)
    cu = codes.view(np.uint32).astype(np.uint64)
    acc = None
    for p, salt in enumerate(_salts(k)):
        h = ((cu ^ salt) * KNUTH) & 0xFFFFFFFF
        got = entries[((np.uint64(p) << np.uint64(32)) | h)
                      >> np.uint64(32 - log2_rows)]
        acc = got if acc is None else acc & got
    want = bloom_word_vmem(torch.from_numpy(table), torch.from_numpy(codes),
                           _salts(k), log2_rows, pack)
    assert 0 < int(np.count_nonzero(acc)) < codes.size
    np.testing.assert_array_equal(acc.astype(np.uint32).view(np.int32),
                                  want.numpy())


@pytest.mark.parametrize("shorts", [False, True])
@pytest.mark.parametrize("q,stride,k,pack,L", [
    (9, 5, 3, 4, 1000),
    (8, 3, 2, 4, 599),
    (9, 7, 4, 4, 1399),
    (16, 20, 2, 1, 3990),  # L % stride != 0, bit 19 alignments
])
def test_rows_filter_matches_jax(q, stride, k, pack, L, shorts):
    """``_filter_hits_sampled_vmem_rows`` bit for bit: slot indices, long
    and short words, ``n_final`` and ``n_coarse``, at a slot capacity
    that drops hits (``n_coarse > cap_coarse``) and one that keeps all,
    and a compaction capacity below and above the survivor count (the
    second with the long path off where shorts are planned)."""
    # every case has a [8, 200] grid: the JAX side's eager ops compile
    # once per shape
    B, log2_rows = 8, 12
    rng = np.random.default_rng(stride * 10 + shorts)
    table = _table(rng, k, log2_rows, pack, 0.02 ** (1.0 / k))
    log2_words = 12
    words = _table(rng, 1, log2_words, 1, 0.8).reshape(-1)
    chunks = rng.choice(np.frombuffer(b"abcdxy", np.uint8), (B, L))
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[0] = L
    short = (b"xy", b"dab") if shorts else ()
    args_j = [jnp.asarray(x) for x in (table, words, chunks, lengths)]
    args_t = [torch.from_numpy(x) for x in (table, words, chunks, lengths)]
    # min_long_len 0 switches the long path off: only shorts survive
    for cap_coarse, capacity, mll in ((2, 4, 9),
                                      (32, 4096, 0 if shorts else 9)):
        kw = dict(q=q, stride=stride, log2_rows=log2_rows, salts=_salts(k),
                  pack=pack, log2_words=log2_words, fine_salts=_salts(2),
                  shorts=short, capacity=capacity, cap_coarse=cap_coarse)
        with jax.disable_jit():
            want = filter_jax._filter_hits_sampled_vmem_rows(
                *args_j, jnp.int32(mll), interpret=True, **kw)
        got = filter_torch.filter_hits_sampled_vmem(
            *args_t, torch.tensor(mll, dtype=torch.int32), **kw)
        for name, a, b in zip(("idx", "lw", "swo", "n_final", "n_coarse"),
                              want, got):
            assert b.dtype == torch.int32, name
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=name)
        n_final, n_coarse = int(got[3]), int(got[4])
        assert n_final > 0 and n_coarse > 0
        if cap_coarse == 2 and mll:
            assert n_coarse > cap_coarse  # some row dropped hits
        if capacity == 4 and mll:
            assert n_final > capacity  # the retry signal


def _needles(n, length, alphabet, seed=1337):
    rng = np.random.default_rng(seed)
    pool = np.frombuffer(alphabet, np.uint8)
    out = set()
    while len(out) < n:
        out.add(rng.choice(pool, length).tobytes())
    return sorted(out)


def _planted_docs(needles, n_docs, doc_len, per_doc, seed, alphabet=b"abcdef",
                  min_len=None):
    """``n_docs`` random documents over ``alphabet``, ``doc_len`` bytes each
    (or ragged, from ``min_len`` up), with ``per_doc`` needles planted."""
    rng = random.Random(seed)
    docs = []
    for _ in range(n_docs):
        n = doc_len if min_len is None else rng.randint(min_len, doc_len)
        d = bytearray(rng.choice(alphabet) for _ in range(n))
        for _ in range(per_doc):
            p = rng.choice(needles)
            o = rng.randrange(n - len(p))
            d[o : o + len(p)] = p
        docs.append(bytes(d))
    return docs


def test_stride5_set_matches_jax():
    """A set planned at stride 5 (13-byte needles): the port's
    ``match_arrays``, ``match_arrays_many`` (its records batch, not the
    sequential fallback) and ``match_many`` dicts equal the JAX
    ``Matcher``'s on planted documents, with a short pattern too."""
    needles = _needles(300, 13, b"abcdef", seed=5)
    specs = [{"id": i, "value": p} for i, p in enumerate(needles)]
    specs.append({"key": "s", "value": b"fab"})
    cfg = dict(backend="device", engine="cascade", bloom_impl="pallas_vmem",
               auto_shard=False, chunk_len=1024)
    mj = ref.Matcher(specs, ref.ScanConfig(**cfg))
    mt = port.Matcher(specs, port.ScanConfig(**cfg), device="cpu")
    pt = mt.cascade_model.plan
    assert pt.reason == mj.cascade_model.plan.reason
    assert pt.stride % 4 and pt.vmem_words is not None and pt.shorts
    assert mt.cascade_model.records_ok
    docs = _planted_docs(needles, 8, 6000, 6, seed=7)
    with jax.disable_jit():
        want = mj.match_arrays(docs)
        want_d = mj.match_many(docs)
    ht = mt.device_corpus(docs)
    assert ht.fused_phases(mt.cascade_model) is None
    _assert_same(want, mt.match_arrays(ht))
    for got in mt.match_arrays_many([ht, ht]):
        _assert_same(want, got)
    assert mt.stats.records_fallbacks == 0
    assert mt.match_many(docs) == want_d
    assert want["doc"].shape[0] >= 8 * 6


def test_headline_rows_set_at_one_mib_matches_jax():
    """``bench.py``'s alphabet with 2048 x 13-byte needles plans q=9,
    stride 5, vmem k=7, pack 4; the port's default route (the cascade from
    ``cascade_min_bytes``, through the per-row filter) over 1 MiB equals
    the JAX ``Matcher``."""
    needles = _needles(2048, 13, b"abcdef")
    specs = [{"id": i, "value": p} for i, p in enumerate(needles)]
    mt = port.Matcher(specs, port.ScanConfig(chunk_len=4096), device="cpu")
    cm = mt.cascade_model
    p = cm.plan
    assert (p.q, p.stride, len(p.vmem_salts), p.vmem_pack) == (9, 5, 7, 4)
    assert p.vmem_words.shape == (56, 128)
    docs = _planted_docs(needles, 128, 8192, 2, seed=11)
    assert mt._pick_engine(sum(map(len, docs))) == "cascade"
    got = mt.match_arrays(docs)
    mj = ref.Matcher(specs, ref.ScanConfig(chunk_len=4096, auto_shard=False,
                                           engine="cascade"))
    _assert_same(mj.match_arrays(docs), got)
    assert got["doc"].shape[0] >= 256
