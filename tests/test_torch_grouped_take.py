"""The grouped take filter's two kernels, through their plain versions,
against the JAX package.

``ops/filter_cuda.grouped_take_extract`` (the grid stage: codes, the
first salt's probe, rank extraction, the per-slot re-probes) and
``grouped_take_refine`` (the prefix refinement of the compacted hits)
run their plain versions on CPU tensors.  Each case holds the extraction
against the JAX package's own stages (``sampled_gram_codes_planes``, the
salted take, ``filter_pallas.group_rank_extract`` and the re-probes of
``filter_jax.filter_hits_sampled_grouped``), and the whole
``filter_hits_sampled_grouped`` against the JAX function, bit for bit.
The JAX side runs op by op under ``jax.disable_jit()``, as
``tests/test_torch_take.py`` runs it: its compile costs more than the
work at these sizes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from php_aho_corasick_tpu.ops import filter_jax, filter_pallas  # noqa: E402

from php_aho_corasick_tpu_torch.ops import filter_cuda, filter_torch  # noqa: E402

SALTS = (0x85EBCA6B, 0xC2B2AE35)
PREFIX_SALTS = (0x7F4A7C15, 0x94D049BB)
LOG2_WORDS, PREFIX_LOG2 = 13, 15
BLOCK_R, CAP_COARSE, CAPACITY = 128, 8, 2048


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _case(seed, stride, q, n_salts, dual, shorts, B=5, M=2001):
    """A corpus over ``abc`` whose grid (``B * M`` cells, not a whole
    number of groups) is a quarter inserted into the positional bloom
    under every salt at one alignment, the top one (bit ``stride - 1``)
    in a third of them, over stray bits at ~1.5/stride a word: columns of
    128 rows hold far more than ``mpr`` hits, and single-alignment hits
    are many.  ``words2`` passes about half the slots."""
    rng = np.random.default_rng(seed)
    L = stride * M
    chunks = rng.integers(97, 100, (B, L), dtype=np.int64).astype(np.uint8)
    lengths = np.full(B, L, np.int32)
    lengths[1] = L // 3
    lengths[3] = 0
    bits = rng.random((1 << LOG2_WORDS, stride)) < 1.5 / stride / 8
    words = (bits * (1 << np.arange(stride, dtype=np.uint64))).sum(1)
    words = words.astype(np.uint64)
    code = filter_torch.sampled_gram_codes(_t(chunks), q, stride).reshape(-1)
    cells = rng.choice(code.shape[0], code.shape[0] // 4, replace=False)
    align = rng.integers(0, stride, cells.shape[0])
    align[::3] = stride - 1
    cu = filter_torch.u32(code[_t(cells)])
    for salt in SALTS[:n_salts]:
        widx = (filter_torch.mul32(cu ^ salt, filter_torch.KNUTH)
                >> (32 - LOG2_WORDS)).numpy()
        np.bitwise_or.at(words, widx, np.uint64(1) << align.astype(np.uint64))
    words = words.astype(np.uint32).view(np.int32)
    words2 = None
    if dual:
        words2 = rng.integers(-(2**31), 2**31, 1 << LOG2_WORDS,
                              dtype=np.int64).astype(np.int32)
    # a half-full prefix bit bloom: single-alignment hits pass or die
    pwords = rng.integers(-(2**31), 2**31, (1 << PREFIX_LOG2) // 32,
                          dtype=np.int64).astype(np.int32)
    return chunks, lengths, words, words2, pwords


def _jax_extract(chunks, lengths, words, words2, mll, q, stride, salts,
                 shorts, mpr):
    """Stages A and B1 of ``filter_jax.filter_hits_sampled_grouped``, from
    the JAX package's own pieces: the slot arrays and counts that the
    plain extraction must equal."""
    B, L = chunks.shape
    M = L // stride
    n_grid = B * M

    def probe(bloom, code, salt):
        h = (code.astype(jnp.uint32) ^ jnp.uint32(salt)) * jnp.uint32(
            filter_jax.KNUTH)
        return jnp.take(bloom, (h >> jnp.uint32(32 - LOG2_WORDS)).astype(
            jnp.int32))

    ch = jnp.asarray(chunks)
    code = filter_jax.sampled_gram_codes_planes(ch, q, stride,
                                                filter_jax.GRAM_BASE)
    w = jnp.where(mll > 0, probe(jnp.asarray(words), code.reshape(-1),
                                 salts[0]), 0)
    sw = (filter_jax._short_start_words(ch, jnp.asarray(lengths), shorts,
                                        stride, M).reshape(-1)
          if shorts else jnp.zeros_like(w))
    hv = (filter_jax.sampled_gram_codes_planes(ch, q, stride,
                                               filter_jax.GRAM_BASE2)
          if words2 is not None else code)
    n_blocks = max(1, -(-(-(-n_grid // 128)) // BLOCK_R))
    tot = n_blocks * BLOCK_R * 128

    def pad(x):
        return jnp.concatenate([x, jnp.zeros((tot - n_grid,), x.dtype)])

    r_s, w_s, swo_s, c_s, cnt = filter_pallas.group_rank_extract(
        pad(w), pad(sw), pad(hv.reshape(-1)), BLOCK_R, mpr, n_blocks, n_grid)
    if words2 is not None:
        w_s = w_s & probe(jnp.asarray(words2), c_s, filter_jax.SALT2)
    else:
        for salt in salts[1:]:
            w_s = w_s & probe(jnp.asarray(words), c_s, salt)
    return r_s, w_s, swo_s, c_s, cnt


@pytest.mark.parametrize("stride,q,n_salts,dual,shorts,prefix_len,mll", [
    (8, 9, 2, False, (), 12, 1),  # the take-grouped cell's plan
    (8, 5, 1, True, (b"ca",), 4, 1),
    (12, 5, 2, True, (), 20, 1),  # the byte-signature plan (q 5, stride 12)
    (12, 9, 1, False, (b"ab", b"c"), 0, 1),  # prefix off
    (16, 9, 2, False, (b"cab",), 4, 1),
    (16, 5, 1, True, (), 20, 1),
    (32, 9, 2, False, (), 20, 1),  # alignment bit 31
    (32, 5, 1, True, (b"bc",), 4, 1),
    (32, 9, 1, False, (b"a",), 0, 1),  # prefix off, a short every 3rd byte
    (8, 9, 2, True, (b"ca",), 12, 0),  # min_long_len 0: shorts only
])
def test_grouped_take_matches_jax(stride, q, n_salts, dual, shorts,
                                  prefix_len, mll):
    chunks, lengths, words, words2, pwords = _case(
        stride * 100 + q * 10 + n_salts, stride, q, n_salts, dual, shorts)
    salts = SALTS[:n_salts]
    B, L = chunks.shape
    mpr = CAP_COARSE
    n_grid = B * (L // stride)
    assert n_grid % (BLOCK_R * 128)  # a ragged grid: padding cells
    prefix = prefix_len > 0
    kw = dict(q=q, stride=stride, log2_words=LOG2_WORDS, salts=salts,
              shorts=shorts, capacity=CAPACITY, cap_coarse=CAP_COARSE,
              prefix_salts=PREFIX_SALTS if prefix else (),
              prefix_log2=PREFIX_LOG2 if prefix else 0,
              prefix_len=prefix_len, block_r=BLOCK_R)
    with jax.disable_jit():
        want_x = _jax_extract(chunks, lengths, words, words2, mll, q, stride,
                              salts, shorts, mpr)
        want = filter_jax.filter_hits_sampled_grouped(
            jnp.asarray(words), jnp.asarray(chunks), jnp.asarray(lengths),
            jnp.int32(mll),
            prefix_words=jnp.asarray(pwords) if prefix else None,
            words2=None if words2 is None else jnp.asarray(words2), **kw)

    # the grid stage's plain version, slot array for slot array
    sw = (filter_torch._short_start_words(_t(chunks), _t(lengths), shorts,
                                          stride, L // stride)
          if shorts else None)
    wc = filter_torch.pack_corpus_words(_t(chunks))
    before = filter_cuda.grouped_take_extract.launches
    got_x = filter_cuda.grouped_take_extract(
        _t(words), wc, sw, torch.tensor(mll, dtype=torch.int32),
        None if words2 is None else _t(words2), q=q, spc=stride // 4,
        log2_words=LOG2_WORDS, salts=salts, mpr=mpr, block_r=BLOCK_R)
    assert filter_cuda.grouped_take_extract.launches == before
    for a, b in zip(want_x, got_x):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    cnt = got_x[4]
    if mll:
        assert int(cnt.max()) > mpr  # a column dropped hits past its slots

    # the whole filter: both plain versions and the compaction between
    before = filter_cuda.grouped_take_refine.launches
    got = filter_torch.filter_hits_sampled_grouped(
        _t(words), _t(chunks), _t(lengths),
        torch.tensor(mll, dtype=torch.int32),
        prefix_words=_t(pwords) if prefix else None,
        words2=None if words2 is None else _t(words2), **kw)
    assert filter_cuda.grouped_take_refine.launches == before
    assert len(want) == len(got)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    n = int(got[3])
    assert 0 < n <= CAPACITY
    live = got[0][:n] < filter_torch.INT32_MAX
    if prefix and mll:
        # the refinement kept some hits and killed others
        assert 0 < int(live.sum()) < n
    else:
        assert bool(live.all())
    if shorts:
        assert int((got[2][:n] != 0).sum()) > 0


def test_refine_reads_windows_across_rows():
    """The refinement hashes each window from the flat corpus pack: a hit
    at a row's first cell hashes the previous row's last bytes (the
    reference clips the word index to the pack, not to the row), where
    the grid stage's q-grams stop at the row's end.  A full prefix bloom
    keeps every hit and an empty one drops every single-alignment hit."""
    stride, spc, l16, mpr = 8, 2, 12, 8
    rng = np.random.default_rng(3)
    chunks = rng.integers(0, 256, (3, 64), dtype=np.int64).astype(np.uint8)
    wc = filter_torch.pack_corpus_words(_t(chunks))
    cells = torch.tensor([8, 16, 23])  # two row starts and the last cell
    r_s = torch.full((mpr, 128), -1, dtype=torch.int32)
    w_s = torch.zeros((mpr, 128), dtype=torch.int32)
    r_s[0, cells] = 0  # slot s of a one-group layout: cell s
    w_s[0, cells] = 1 << (stride - 1)  # windows starting 7 bytes back
    slot = torch.cat([cells.to(torch.int32),
                      torch.tensor([filter_torch.INT32_MAX], dtype=torch.int32)])
    kw = dict(mpr=mpr, block_r=128, spc=spc, prefix_salts=PREFIX_SALTS,
              prefix_log2=15, prefix_len=l16)
    outs = [filter_cuda.grouped_take_refine(
        slot, r_s, w_s, torch.zeros_like(w_s), wc,
        torch.full(((1 << 15) // 32,), fill, dtype=torch.int32), **kw)
        for fill in (-1, 0)]
    assert outs[0][0].tolist() == cells.tolist() + [filter_torch.INT32_MAX]
    assert outs[1][0].tolist() == [filter_torch.INT32_MAX] * 4
    assert outs[1][1].tolist() == [0] * 4

    def get_plane(c):
        widx = torch.clamp(cells.long() * spc + c, 0, wc.numel() - 1)
        return wc.reshape(-1)[widx]

    h = filter_cuda._prefix_hash_select(get_plane, w_s[0, cells], stride,
                                        l16, filter_cuda._window_offsets(spc))
    flat = chunks.reshape(-1).tolist()
    for cell, hv in zip(cells.tolist(), h.tolist()):
        start = cell * stride - (stride - 1)
        want = 0
        for i, b in enumerate(flat[start : start + l16]):
            want += b * pow(filter_torch.GRAM_BASE, l16 - 1 - i, 1 << 32)
        assert hv & filter_torch.U32_MASK == want & filter_torch.U32_MASK
