"""The port's sampled take filters against the JAX package's.

Sampled plans without a bank bloom (needle sets of ~8k and more), the
settings ``bloom_impl="take"`` and ``"pallas"``, and launches that saw more
than 128 survivors in one extraction group (``_force_take``) probe the
positional bloom by gathers: the grouped take filter where the stride is
a multiple of 4 dividing the row, else the flat one.  Every comparison
here is exact: codes, slot arrays and counts bit for bit, records array
for array.  The JAX side runs op by op under ``jax.disable_jit()`` where
XLA's compile costs more than the work, and jitted where its op-by-op
dispatch costs more (the Matcher-level cases).
"""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import php_aho_corasick_tpu as ref  # noqa: E402
from php_aho_corasick_tpu.models import cascade as ref_cascade  # noqa: E402
from php_aho_corasick_tpu.ops import filter_jax  # noqa: E402

import php_aho_corasick_tpu_torch as port  # noqa: E402
from php_aho_corasick_tpu_torch.models import cascade as port_cascade  # noqa: E402
from php_aho_corasick_tpu_torch.ops import filter_cuda, filter_torch  # noqa: E402
from test_torch_slice import _assert_same  # noqa: E402

SALTS = (0x85EBCA6B, 0xC2B2AE35)
PREFIX_SALTS = (0x7F4A7C15, 0x94D049BB)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _same(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("q,stride,L", [(9, 8, 1024), (16, 20, 2000),
                                        (5, 32, 4096), (12, 4, 512),
                                        (10, 7, 700)])
def test_sampled_codes_match_jax(q, stride, L):
    """The strided codes (the flat and per-row filters') equal the JAX
    package's ``sampled_codes_best``; where ``stride % 4 == 0`` and
    ``stride | L``, the grouped filter's codes from the word planes equal
    its ``sampled_gram_codes_planes`` and the strided ones bit for bit."""
    rng = np.random.default_rng(q * 100 + stride)
    chunks = rng.integers(0, 256, (3, L), dtype=np.int64).astype(np.uint8)
    for base in (filter_torch.GRAM_BASE, filter_torch.GRAM_BASE2):
        want = np.asarray(filter_jax.sampled_codes_best(
            jnp.asarray(chunks), q, stride, base))
        got = filter_torch.sampled_gram_codes(_t(chunks), q, stride, base)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        if stride % 4 == 0 and L % stride == 0:
            wc = filter_torch.pack_corpus_words(_t(chunks))
            planes = filter_torch.to_i32(filter_torch._planes_code(
                filter_torch._word_planes(wc, q, stride // 4), q, base))
            np.testing.assert_array_equal(
                planes.numpy(), np.asarray(filter_jax.sampled_gram_codes_planes(
                    jnp.asarray(chunks), q, stride, base)))
            np.testing.assert_array_equal(planes.numpy(), got.numpy())


def _bloom_case(seed, stride, q, B=6, n_rows=48, log2_words=13, shorts=(),
                alphabet=b"abc"):
    """A corpus over ``alphabet`` and a positional bloom whose words hold
    a few random alignment bits (each set at ~1.5/stride), with a quarter
    of the grid cells' grams inserted under both salts at one alignment,
    the top one (bit ``stride - 1``) included, so single-alignment hits
    are many."""
    rng = np.random.default_rng(seed)
    L = stride * n_rows
    pool = np.frombuffer(alphabet, np.uint8)
    chunks = pool[rng.integers(0, len(pool), (B, L))]
    lengths = np.full(B, L, np.int32)
    lengths[2] = L // 3
    lengths[4] = 0
    bits = rng.random((1 << log2_words, stride)) < 1.5 / stride / 8
    words = (bits * (1 << np.arange(stride, dtype=np.uint64))).sum(1)
    words = words.astype(np.uint64)
    code = filter_torch.sampled_gram_codes(_t(chunks), q, stride).reshape(-1)
    cells = rng.choice(code.shape[0], code.shape[0] // 4, replace=False)
    align = rng.integers(0, stride, cells.shape[0])
    align[::3] = stride - 1
    cu = filter_torch.u32(code[_t(cells)])
    for salt in SALTS:
        widx = (filter_torch.mul32(cu ^ salt, filter_torch.KNUTH)
                >> (32 - log2_words)).numpy()
        np.bitwise_or.at(words, widx, np.uint64(1) << align.astype(np.uint64))
    words = words.astype(np.uint32).view(np.int32)
    return chunks, lengths, words


@pytest.mark.parametrize("stride,q,shorts", [
    (7, 10, ()),  # the default-config plan's stride: the strided codes
    (7, 10, (b"ab", b"c")),
    (8, 9, (b"ca",)),  # a stride-8 plan after _force_take
])
def test_filter_hits_sampled_matches_jax(stride, q, shorts):
    chunks, lengths, words = _bloom_case(stride, stride, q)
    kw = dict(q=q, stride=stride, log2_words=13, salts=SALTS, shorts=shorts,
              capacity=4096)
    want = filter_jax.filter_hits_sampled(
        jnp.asarray(words), jnp.asarray(chunks), jnp.asarray(lengths),
        jnp.int32(q + stride - 1), **kw)
    got = filter_torch.filter_hits_sampled(
        _t(words), _t(chunks), _t(lengths),
        torch.tensor(q + stride - 1, dtype=torch.int32), **kw)
    _same(want, got)
    n = int(got[3])
    assert 0 < n <= 4096
    idx = got[0][:n]
    assert bool((idx[1:] > idx[:-1]).all())  # ascending grid cells
    assert int((got[1][:n] != 0).sum()) > 0
    if shorts:
        assert int((got[2][:n] != 0).sum()) > 0
    # a capacity below the count keeps the first hits and reports them all
    small = filter_torch.filter_hits_sampled(
        _t(words), _t(chunks), _t(lengths),
        torch.tensor(q + stride - 1, dtype=torch.int32),
        **dict(kw, capacity=n // 2))
    assert int(small[3]) == n
    np.testing.assert_array_equal(small[0].numpy(), idx[: n // 2].numpy())


FLAT_CASES = {
    # stride, q, n_rows, salts, shorts, min_long_len, alphabet
    # the genome's class: ACGT rows of 4,224 bytes, q 15, stride 6, a salt
    "genome": (6, 15, 704, SALTS[:1], (), 20, b"ACGT"),
    "shorts": (7, 10, 48, SALTS, (b"ab", b"c"), 16, b"abc"),
    "stride32": (32, 16, 40, SALTS, (), 47, b"abcd"),
    "mll0": (9, 12, 50, SALTS, (b"ca",), 0, b"abc"),
}


@pytest.mark.parametrize("case", sorted(FLAT_CASES))
def test_flat_take_extract_matches_jax(case):
    """The flat take filter's wrapper on CPU tensors (its plain version:
    no launch is counted) equals ``filter_jax.filter_hits_sampled``, at
    a capacity that holds every hit and at one that holds half."""
    stride, q, n_rows, salts, shorts, mll, alphabet = FLAT_CASES[case]
    chunks, lengths, words = _bloom_case(q * stride, stride, q, B=7,
                                         n_rows=n_rows, alphabet=alphabet)
    M = chunks.shape[1] // stride
    sw = (filter_torch._short_start_words(_t(chunks), _t(lengths), shorts,
                                          stride, M) if shorts else None)
    before = filter_cuda.flat_take_extract.launches
    n = None
    for capacity in (4096, None):
        capacity = capacity or max(1, n // 2)
        kw = dict(q=q, stride=stride, log2_words=13, salts=salts,
                  capacity=capacity)
        want = filter_jax.filter_hits_sampled(
            jnp.asarray(words), jnp.asarray(chunks), jnp.asarray(lengths),
            jnp.int32(mll), shorts=shorts, **kw)
        got = filter_cuda.flat_take_extract(
            _t(words), _t(chunks), sw, torch.tensor(mll, dtype=torch.int32),
            **kw)
        assert all(t.dtype == torch.int32 for t in got)
        _same(want, got)
        n = n or int(got[3])
        assert int(got[3]) == n and 0 < n <= 4096
        assert n > capacity or capacity == 4096
    assert filter_cuda.flat_take_extract.launches == before
    if mll == 0:
        assert not bool((got[1] != 0).any())


def test_filter_hits_sampled_calls_flat_take_extract(monkeypatch):
    """``filter_hits_sampled`` hands the grid work to the wrapper once,
    with the short-start words only where the plan has shorts."""
    seen = []
    real = filter_cuda.flat_take_extract

    def spy(words, chunks, sw, mll, **kw):
        seen.append((sw is None, kw))
        return real(words, chunks, sw, mll, **kw)

    monkeypatch.setattr(filter_cuda, "flat_take_extract", spy)
    chunks, lengths, words = _bloom_case(3, 7, 10)
    for shorts in ((), (b"ab",)):
        filter_torch.filter_hits_sampled(
            _t(words), _t(chunks), _t(lengths),
            torch.tensor(16, dtype=torch.int32), q=10, stride=7,
            log2_words=13, salts=SALTS, shorts=shorts, capacity=512)
    assert [s for s, _ in seen] == [True, False]
    assert seen[0][1] == dict(q=10, stride=7, log2_words=13, salts=SALTS,
                              capacity=512)


def _flat_inputs():
    chunks, lengths, words = _bloom_case(5, 8, 9, B=5, n_rows=16)
    return dict(words=_t(words), chunks=_t(chunks),
                sw=torch.zeros((5, 16), dtype=torch.int32),
                mll=torch.tensor(16, dtype=torch.int32))


FLAT_BAD = {
    "q17": (dict(q=17), {}, ValueError),
    "salts9": (dict(salts=tuple(range(1, 10))), {}, ValueError),
    "no_salt": (dict(salts=()), {}, ValueError),
    "stride33": (dict(stride=33), {}, ValueError),
    "capacity0": (dict(capacity=0), {}, ValueError),
    "words_int64": ({}, dict(words=lambda t: t.long()), TypeError),
    "words_short": ({}, dict(words=lambda t: t[:-1]), ValueError),
    "chunks_1d": ({}, dict(chunks=lambda t: t.reshape(-1)), ValueError),
    "chunks_int32": ({}, dict(chunks=lambda t: t.to(torch.int32)), TypeError),
    "chunks_strided": ({}, dict(chunks=lambda t: t[:, ::2]), ValueError),
    "sw_shape": ({}, dict(sw=lambda t: t[:, :-1]), ValueError),
    "mll_two": ({}, dict(mll=lambda t: t.repeat(2)), ValueError),
}


@pytest.mark.parametrize("case", sorted(FLAT_BAD))
def test_flat_take_extract_input_checks(case):
    """What the kernel does not take raises before a launch: the checks
    the wrapper makes on a CUDA tensor, run here on CPU tensors."""
    kw = dict(q=9, stride=8, log2_words=13, salts=SALTS, capacity=64)
    a = _flat_inputs()
    filter_cuda.check_flat_inputs(*a.values(), **kw)  # the good inputs pass
    bad_kw, bad_t, err = FLAT_BAD[case]
    for name, f in bad_t.items():
        a[name] = f(a[name])
    if "chunks" in bad_t and a["chunks"].dim() == 2:
        # a strided view keeps its rows: the short words' shape follows
        a["sw"] = torch.zeros((a["chunks"].shape[0],
                               -(-a["chunks"].shape[1] // 8)),
                              dtype=torch.int32)
    with pytest.raises(err):
        filter_cuda.check_flat_inputs(*a.values(), **dict(kw, **bad_kw))


def test_flat_take_extract_build_entry(tmp_path, monkeypatch):
    """``flat_take_extract`` is built like the other kernels, and its
    source enters no other kernel's library digest."""
    import shutil

    from php_aho_corasick_tpu_torch.ops import _build

    name = "flat_take_extract"
    assert name in _build.KERNELS and (_build.CSRC / f"{name}.cu").exists()
    with_it = {n: _build.library_path(n).name for n in _build.KERNELS}
    assert with_it[name].startswith(f"lib{name}-")
    bare = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, bare)
    (bare / f"{name}.cu").unlink()
    monkeypatch.setattr(_build, "CSRC", bare)
    others = [n for n in _build.KERNELS if n != name]
    assert {n: _build.library_path(n).name for n in others} == {
        n: with_it[n] for n in others}


class _RefineSpy:
    """Records, for each call of ``filter_cuda.grouped_take_refine``,
    whether it was given the prefix bit bloom (on a CPU tensor its plain
    version runs, and no launch is counted)."""

    def __init__(self, monkeypatch):
        self.prefix = []
        real = filter_cuda.grouped_take_refine

        def spy(slot, r_s, w_s, swo_s, wc, prefix_words=None, **kw):
            self.prefix.append(prefix_words is not None)
            assert slot.dtype == torch.int32
            return real(slot, r_s, w_s, swo_s, wc, prefix_words, **kw)

        monkeypatch.setattr(filter_cuda, "grouped_take_refine", spy)


@pytest.mark.parametrize("stride,q,prefix,dual,shorts", [
    (8, 9, False, False, ()),
    (8, 9, True, False, (b"ca",)),
    (8, 9, True, True, ()),
    (20, 16, True, False, ()),
    (32, 12, True, False, ()),  # alignment bit 31: the reference's sign bug
    (32, 12, True, True, ()),
    (32, 12, False, True, (b"ab",)),
])
def test_filter_hits_sampled_grouped_matches_jax(monkeypatch, stride, q,
                                                 prefix, dual, shorts):
    chunks, lengths, words = _bloom_case(stride + q, stride, q, B=5)
    rng = np.random.default_rng(stride)
    # a half-full prefix bit bloom: single-alignment hits pass or die
    pwords = rng.integers(-(2**31), 2**31, (1 << 15) // 32,
                          dtype=np.int64).astype(np.int32)
    words2 = None
    if dual:  # the second code family passes at about half the slots
        words2 = rng.integers(-(2**31), 2**31, 1 << 13,
                              dtype=np.int64).astype(np.int32)
    kw = dict(q=q, stride=stride, log2_words=13, salts=SALTS, shorts=shorts,
              capacity=1024, cap_coarse=24, prefix_salts=PREFIX_SALTS,
              prefix_log2=15, prefix_len=12, block_r=128)
    mll = q + stride - 1
    with jax.disable_jit():
        want = filter_jax.filter_hits_sampled_grouped(
            jnp.asarray(words), jnp.asarray(chunks), jnp.asarray(lengths),
            jnp.int32(mll),
            prefix_words=jnp.asarray(pwords) if prefix else None,
            words2=None if words2 is None else jnp.asarray(words2), **kw)
    spy = _RefineSpy(monkeypatch)
    got = filter_torch.filter_hits_sampled_grouped(
        _t(words), _t(chunks), _t(lengths),
        torch.tensor(mll, dtype=torch.int32),
        prefix_words=_t(pwords) if prefix else None,
        words2=None if words2 is None else _t(words2), **kw)
    _same(want, got)
    assert spy.prefix == [prefix]
    n, n_coarse = int(got[3]), int(got[4])
    assert 0 < n <= 1024 and 0 < n_coarse <= 24
    if prefix:
        # the refinement kept some hits and killed others, at the top
        # alignment bit too
        live = got[0][:n] < filter_torch.INT32_MAX
        assert 0 < int(live.sum()) < n
        top = filter_torch.u32(got[1][:n]) == 1 << (stride - 1)
        assert int(top.sum()) > 0


def test_force_take_escape_at_pathological_density():
    """``tests/test_cascade.py``'s pathological density on both packages:
    a match every 16 bytes puts > 128 survivors in every extraction
    group, so the model switches for good to the flat take filter and
    stays exact; a second call on the same matcher gives the same
    records."""
    p = b"abcdefabcdefabcd"
    text = p * 70000
    cfg = dict(backend="device", engine="cascade", auto_shard=False,
               cascade_mode="sampled", bloom_impl="pallas_vmem",
               chunk_len=4096)
    mj = ref.Matcher([{"id": 0, "value": p}], ref.ScanConfig(**cfg))
    mt = port.Matcher([{"id": 0, "value": p}], port.ScanConfig(**cfg),
                      device="cpu")
    cm = mt.cascade_model
    assert cm.plan.vmem_words is not None and cm.bloom_impl() == "pallas_vmem"
    got = mt.match(text)
    assert cm._force_take and cm.bloom_impl() == "take"
    assert cm.take_branch(4096) == "flat"
    assert len(got) == 70000
    assert got[0]["pos"] == 16 and got[-1]["pos"] == len(text)
    assert mt.match(text) == got
    # jitted: XLA's compile of the reference's programs is most of this
    # test's time, and op by op is slower still
    want = mj.match(text)
    assert mj.cascade_model._force_take
    assert got == want


def _needles(n, length=16, seed=1337):
    rng = random.Random(seed)
    out = set()
    while len(out) < n:
        out.add(bytes(rng.choice(b"abcdef") for _ in range(length)))
    return sorted(out)


def _corpus(needles, n_bytes, n_docs, seed, plants=40):
    """``n_docs`` documents over ``abcdef`` of ``n_bytes`` in all, with
    needles planted at random."""
    rng = np.random.default_rng(seed)
    doc = bytearray(rng.choice(np.frombuffer(b"abcdef", np.uint8),
                               n_bytes).tobytes())
    for k in range(plants):
        p = needles[(k * 97) % len(needles)]
        o = int(rng.integers(0, n_bytes - len(p)))
        doc[o : o + len(p)] = p
    cuts = np.linspace(0, n_bytes, n_docs + 1).astype(int)
    return [bytes(doc[a:b]) for a, b in zip(cuts[:-1], cuts[1:])]


def test_default_config_without_bank_bloom_matches_jax():
    """8,192 needles of 16 bytes at the default config: the planner
    builds no bank bloom (q=10, stride 7, a 2^26-word positional bloom),
    so a scan of at least ``cascade_min_bytes`` takes the flat take filter
    and emits records on the device, as the JAX package's does."""
    needles = _needles(8192)
    specs = [{"id": i, "value": p} for i, p in enumerate(needles)]
    mt = port.Matcher(specs, device="cpu")
    cm = mt.cascade_model
    p = cm.plan
    assert (p.q, p.stride, p.log2_words, p.vmem_words) == (10, 7, 26, None)
    assert cm.bloom_impl() == "take" and cm.records_ok
    docs = _corpus(needles, (1 << 20) + 4096, 3, seed=8192)
    assert mt._pick_engine(sum(map(len, docs))) == "cascade"
    got = mt.match_arrays(docs)
    assert cm.take_branch(mt._pack_chunk_len()) == "flat"
    # jitted: op by op the reference's window walk takes minutes here
    want = ref.Matcher(specs).match_arrays(docs)
    _assert_same(want, got)
    assert got["doc"].shape[0] >= 40


def test_grouped_take_route_matches_jax():
    """``bloom_impl="take"`` on a stride-8 plan (the headline's) takes the
    grouped filter with the prefix refinement, on fresh documents and on
    a resident corpus, equal to the JAX package's and to the bank-bloom
    route's."""
    needles = _needles(300)
    specs = [{"id": i, "value": p} for i, p in enumerate(needles)]
    cfg = dict(backend="device", engine="cascade", chunk_len=2048,
               bloom_impl="take")
    mt = port.Matcher(specs, port.ScanConfig(**cfg), device="cpu")
    cm = mt.cascade_model
    assert cm.plan.stride % 4 == 0 and cm.plan.prefix_words is not None
    assert cm.bloom_impl() == "take"
    assert cm.take_branch(mt._row_align() * 16) == "grouped"
    docs = _corpus(needles, 300_000, 4, seed=256)
    h = mt.device_corpus(docs)
    assert cm.take_branch(h.chunks_d.shape[1]) == "grouped"
    assert h.fused_phases(cm) is None
    got = mt.match_arrays_many([h, h])
    assert mt.stats.records_fallbacks == 0
    # jitted: op by op the reference's filter and walk take minutes here
    want = ref.Matcher(specs, ref.ScanConfig(**cfg)).match_arrays(docs)
    for g in got + [mt.match_arrays(docs)]:
        _assert_same(want, g)
    mv = port.Matcher(specs, port.ScanConfig(**dict(cfg,
                                                    bloom_impl="auto")),
                      device="cpu")
    assert mv.cascade_model.bloom_impl() == "pallas_vmem"
    _assert_same(want, mv.match_arrays(docs))
    assert want["doc"].shape[0] >= 40


def test_grouped_take_dual_code_matches_jax(monkeypatch):
    """The second code family (``sampled_words2``), built by the planner
    only at ``WORDS2_MIN_ENTRIES`` entries, forced on a small set in both
    packages: the grouped filter re-probes its slots by ``GRAM_BASE2``
    and stays exact (``tests/test_cascade.py``'s dual-code case)."""
    monkeypatch.setattr(ref_cascade, "WORDS2_MIN_ENTRIES", 1)
    monkeypatch.setattr(port_cascade, "WORDS2_MIN_ENTRIES", 1)
    rng = random.Random(17)
    patterns = sorted({bytes(rng.choice(b"abcdef") for _ in range(16))
                       for _ in range(300)})  # stride 8: the grouped gate
    text = bytearray(rng.choice(b"abcdef") for _ in range(40000))
    for _ in range(25):
        p = rng.choice(patterns)
        pos = rng.randrange(0, len(text) - len(p))
        text[pos : pos + len(p)] = p
    docs = [bytes(text[:25000]), bytes(text[25000:])]
    specs = [{"id": i, "value": p} for i, p in enumerate(patterns)]
    cfg = dict(backend="device", engine="cascade", auto_shard=False,
               cascade_mode="sampled", bloom_impl="take")
    mt = port.Matcher(specs, port.ScanConfig(**cfg), device="cpu")
    cm = mt.cascade_model
    assert cm.plan.sampled_words2 is not None
    assert "sampled_words2" in cm.device_arrays
    assert cm.take_branch(mt._row_align()) == "grouped"
    got = mt.match_arrays(docs)
    want = ref.Matcher(specs, ref.ScanConfig(**cfg)).match_arrays(docs)
    _assert_same(want, got)
    assert got["doc"].shape[0] >= 25


def _plan_model(kind, **cfg):
    """A port cascade model of a small set with the given plan kind:
    ``"vmem"`` (sampled, bank bloom built), ``"anchored"``, or
    ``"no_vmem"`` (sampled, the bank bloom dropped as the planner drops
    it for large sets)."""
    if kind == "anchored":
        pats = _needles(64, length=7, seed=3)
        cfg = dict(cfg, cascade_mode="anchored")
    else:
        pats = _needles(300, seed=4)
    m = port.Matcher([{"value": p} for p in pats],
                     port.ScanConfig(**cfg), device="cpu")
    cm = m.cascade_model
    if kind == "no_vmem":
        cm.plan.vmem_words = None
    return cm


@pytest.mark.parametrize("kind,impl,force,want", [
    ("vmem", "auto", False, "pallas_vmem"),
    ("vmem", "pallas_vmem", False, "pallas_vmem"),
    ("vmem", "take", False, "take"),
    ("vmem", "pallas", False, "take"),
    ("vmem", "auto", True, "take"),
    ("vmem", "pallas_vmem", True, "take"),
    ("no_vmem", "auto", False, "take"),
    ("no_vmem", "pallas_vmem", False, "take"),
    ("anchored", "auto", False, "pallas"),
    ("anchored", "take", False, "pallas"),
    ("anchored", "pallas_vmem", False, "pallas"),
])
def test_bloom_impl_routing(kind, impl, force, want):
    cm = _plan_model(kind, bloom_impl=impl)
    assert cm.plan.mode == ("anchored" if kind == "anchored" else "sampled")
    cm._force_take = force
    assert cm.bloom_impl() == want


def test_take_branch_gate():
    """The grouped take filter needs ``stride % 4 == 0``, ``stride | L``,
    a slot capacity of at most 128 and no ``_force_take``; else flat."""
    cm = _plan_model("vmem", bloom_impl="take")
    s = cm.plan.stride
    assert s % 4 == 0
    assert cm.take_branch(128 * s) == "grouped"
    assert cm.take_branch(128 * s + 4) == "flat"
    assert cm.take_branch(128 * s, cap_coarse=129) == "flat"
    cm._force_take = True
    assert cm.take_branch(128 * s) == "flat"
    odd = port.Matcher([{"value": p} for p in _needles(40, length=10,
                                                         seed=3)],
                       port.ScanConfig(bloom_impl="take"),
                       device="cpu").cascade_model
    assert odd.plan.stride % 4
    assert odd.take_branch(odd.plan.stride * 128) == "flat"


def test_grouped_cap_coarse_seed_matches_jax():
    """Without a bank bloom the slot capacity is seeded from the grouped
    filter's single-salt stray, with its group size, as the reference
    seeds it."""
    needles = _needles(300)
    specs = [{"value": p} for p in needles]
    mt = port.Matcher(specs, device="cpu").cascade_model
    mj = ref.Matcher(specs).cascade_model
    assert mt._cap_coarse == mj._cap_coarse
    for cm in (mt, mj):
        cm.plan.vmem_words = None
    a = port_cascade.CascadeModel(mt.auto, mt.plan, mt.config,
                                  dense_model=mt.dense_model)
    b = ref_cascade.CascadeModel(mj.auto, mj.plan, mj.config,
                                 dense_model=mj.dense_model)
    assert a.take_group_block_r() == b.take_group_block_r()
    assert a._take_stray1() == b._take_stray1()
    assert (a._cap_coarse, a._cap_coarse_floor) == (
        b._cap_coarse, b._cap_coarse_floor)
