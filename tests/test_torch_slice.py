"""The port's resident-corpus serving path against the JAX package's.

The JAX side runs as its own CPU tests run it: ``bloom_impl="pallas_vmem"``
makes its cascade take the fused records chain (through the XLA mirror of
its Pallas kernel).  The port runs on CPU tensors (``device="cpu"``).
"""

import dataclasses
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import jax.numpy as jnp  # noqa: E402

import php_aho_corasick_tpu as ref  # noqa: E402
from php_aho_corasick_tpu.ops.filter_jax import (  # noqa: E402
    fused_phase_grid as jax_phase_grid,
)

import php_aho_corasick_tpu_torch as port  # noqa: E402
from php_aho_corasick_tpu_torch import carry  # noqa: E402
from php_aho_corasick_tpu_torch.models.cascade import CascadeModel  # noqa: E402
from php_aho_corasick_tpu_torch.models.dense_dfa import (  # noqa: E402
    DenseDfaModel,
)
from php_aho_corasick_tpu_torch.ops.filter_torch import (  # noqa: E402
    fused_phase_grid,
)
from php_aho_corasick_tpu_torch.parallel.mesh import local_shards  # noqa: E402

CFG = dict(backend="device", engine="cascade", bloom_impl="pallas_vmem",
           auto_shard=False, chunk_len=1024)


@pytest.fixture(autouse=True)
def _jax_eager():
    """Run the JAX side op by op: at these sizes XLA's compile of its
    unrolled mirror costs far more than the work, and the results are
    the same."""
    with jax.disable_jit():
        yield


def _matchers(patterns, **extra):
    specs = [{"id": i, "value": p} for i, p in enumerate(patterns)]
    cfg = dict(CFG, **extra)
    mj = ref.Matcher(config=ref.ScanConfig(**cfg))
    mt = port.Matcher(config=port.ScanConfig(**cfg), device="cpu")
    assert mj.add_patterns(specs) == mt.add_patterns(specs)
    mj.finalize()
    mt.finalize()
    return mj, mt


def _mixed_patterns(rng, lo, shorts):
    alphabet = b"abcdef"
    pats = [bytes(rng.choice(alphabet) for _ in range(rng.randint(lo, lo + 6)))
            for _ in range(rng.randint(20, 60))]
    pats += [p[-lo:] for p in pats[:6] if len(p) > lo]  # suffix factors
    pats += [pats[0][: lo // 2] + pats[1][: lo - lo // 2]]  # an overlap
    if shorts:
        pats += [b"xy", b"q"]
    return list(dict.fromkeys(pats))


def _mixed_case(seed):
    """Mixed long patterns with suffix factors and overlaps, shorts on
    odd seeds, and documents with planted occurrences.  The first draw
    whose plan takes the fused records path (stride a multiple of 4,
    windows of at most 31 bytes) is used."""
    for attempt in range(100):
        rng = random.Random(5100 + 100 * attempt + seed)
        pats = _mixed_patterns(rng, (9, 13, 10, 9)[seed % 4], seed % 2)
        cm = port.Matcher([{"value": p} for p in pats],
                          port.ScanConfig(**CFG), device="cpu").cascade_model
        if cm.plan.stride % 4 == 0 and cm.records_ok:
            break
    else:
        raise AssertionError("no draw took the fused records path")
    docs = []
    for _ in range(rng.randint(3, 9)):
        d = bytearray(rng.choice(b"abcdef")
                      for _ in range(rng.randint(100, 20_000)))
        for _ in range(len(d) // 300):
            p = rng.choice(pats)
            o = rng.randrange(0, max(1, len(d) - len(p)))
            d[o : o + len(p)] = p
        docs.append(bytes(d))
    return pats, docs


def _headline_case(n_bytes):
    """``bench.py``'s headline set: 2048 needles x 16 bytes over
    ``abcdef``, and ``n_bytes`` of 8 KiB documents, with needles planted."""
    rng = random.Random(1337)
    needles = set()
    while len(needles) < 2048:
        needles.add(bytes(rng.choice(b"abcdef") for _ in range(16)))
    needles = sorted(needles)
    docs = [bytearray(rng.choice(b"abcdef") for _ in range(8192))
            for _ in range(n_bytes // 8192)]
    for i in range(0, len(docs) * 4):
        d = docs[rng.randrange(len(docs))]
        o = rng.randrange(8192 - 16)
        d[o : o + 16] = needles[rng.randrange(len(needles))]
    return needles, [bytes(d) for d in docs]


def _assert_same(res_j, res_t):
    assert res_j.keys() == res_t.keys()
    for k in res_j:
        np.testing.assert_array_equal(np.asarray(res_j[k]), res_t[k],
                                      err_msg=k)


@pytest.mark.parametrize("seed", range(4))
def test_match_arrays_many_matches_jax(seed):
    pats, docs = _mixed_case(seed)
    mj, mt = _matchers(pats)
    assert mt.cascade_model.plan.reason == mj.cascade_model.plan.reason
    assert mt.cascade_model.plan.stride % 4 == 0
    hj, ht = mj.device_corpus(docs), mt.device_corpus(docs)
    for find_all in (True, False):
        got_j = mj.match_arrays_many([hj, hj], find_all=find_all)
        got_t = mt.match_arrays_many([ht, ht], find_all=find_all)
        assert len(got_t) == 2
        for a, b in zip(got_j, got_t):
            _assert_same(a, b)
        # a document list goes through device_corpus + the same scan
        _assert_same(got_t[0], mt.match_arrays(docs, find_all=find_all))
    assert got_t[0]["doc"].shape[0] > 0


def test_headline_set_matches_jax():
    needles, docs = _headline_case(256 * 1024)
    mj, mt = _matchers(needles)
    pj, pt = mj.cascade_model.plan, mt.cascade_model.plan
    assert (pt.q, pt.stride, pt.vmem_pack, len(pt.vmem_salts)) == (9, 8, 4, 8)
    for name in ("vmem_words", "prefix_words", "sampled_words"):
        np.testing.assert_array_equal(getattr(pj, name), getattr(pt, name))
    res_j = mj.match_arrays_many([mj.device_corpus(docs)])[0]
    res_t = mt.match_arrays_many([mt.device_corpus(docs)])[0]
    _assert_same(res_j, res_t)
    assert res_t["doc"].shape[0] >= len(docs)


@pytest.mark.parametrize("n, high", [(0, 1), (1, 1), (500, 40),
                                     (200_000, 2**32)])
def test_sorted_distinct_equals_unique(n, high):
    """The planner counts distinct codes and prefix hashes by a sort
    (``models/cascade._sorted_distinct``): ``np.unique``'s values and
    dtype, duplicates and empty input included."""
    from php_aho_corasick_tpu_torch.models.cascade import _sorted_distinct

    a = np.random.default_rng(n).integers(0, high, n, dtype=np.uint64)
    a = a.astype(np.uint32)
    got, want = _sorted_distinct(a), np.unique(a)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_headline_plan_density_equals_jax():
    """The plan's candidate density, which counts distinct gram codes,
    equals the JAX package's on the headline set."""
    needles, _docs = _headline_case(64 * 1024)
    mj, mt = _matchers(needles)
    assert (mt.cascade_model.plan.est_cand_density
            == mj.cascade_model.plan.est_cand_density)


@pytest.mark.parametrize("stage2", ["in_kernel", "prefix_probe", "fine"])
def test_records_chain_on_carried_tables(stage2):
    """The port's records chain on the JAX package's own automaton and
    plan, carried across as plain arrays: the five outputs bit for bit.
    ``stage2`` picks the slot refinement: the in-kernel prefix probe
    (the planner's choice here), a prefix bloom too large for the kernel
    (> 32 rows: probed after extraction), or no prefix plan (the fine
    positional-bloom re-probe)."""
    from php_aho_corasick_tpu.models.cascade import (
        CascadeModel as RefCascadeModel,
    )

    pats, docs = _mixed_case(1)
    mj, _ = _matchers(pats)
    plan_j = mj.cascade_model.plan
    if stage2 == "prefix_probe":
        rng = np.random.default_rng(3)
        plan_j = dataclasses.replace(
            plan_j, prefix_log2=18,
            prefix_words=rng.integers(-(2**31), 2**31, (1 << 18) // 32,
                                      dtype=np.int64).astype(np.int32),
        )
    elif stage2 == "fine":
        plan_j = dataclasses.replace(plan_j, prefix_salts=())
    cmj = RefCascadeModel(mj.automaton, plan_j, mj.config,
                          dense_model=mj.model)

    def fields(obj):
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}

    auto = carry.automaton_from_arrays(fields(cmj.auto))
    plan = carry.plan_from_arrays(fields(plan_j))
    cfg = port.ScanConfig(**dataclasses.asdict(mj.config))
    cmt = CascadeModel(auto, plan, cfg,
                       dense_model=DenseDfaModel(auto, cfg, "cpu"))
    pk = mj.device_corpus(docs).packed
    spc = plan.stride // 4
    args_j = (jnp.asarray(pk.chunks), jnp.asarray(pk.lengths),
              jnp.asarray(pk.emit_from))
    args_t = tuple(torch.from_numpy(x)
                   for x in (pk.chunks, pk.lengths, pk.emit_from))
    caps = ((4096, 256), (256, 16)) if stage2 == "in_kernel" else (
        (4096, 256),)
    for cap_a, cap_r in caps:
        want = cmj.launch_device_records(
            *args_j, cap_a, cap_r,
            phase_g=jax_phase_grid(args_j[0], spc=spc),
        )
        got = cmt.launch_device_records(
            *args_t, cap_a, cap_r,
            phase_g=fused_phase_grid(args_t[0], spc=spc),
        )
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert int(got[3]) > 0


def test_once_unported_modes_match_jax():
    """The modes once pinned here as raising now equal the JAX package's
    records: the take filter (``bloom_impl="take"``), the sharded corpus
    (``device_corpus(docs, shard=True)`` over as many shards of the CPU
    as the JAX package's mesh has devices), the k-gram engine and the
    compressed table (their JAX side jitted: its op-by-op walks cost more
    than XLA's compile, and its sharded scan runs only jitted)."""
    pats, docs = _mixed_case(0)
    mj, m = _matchers(pats, bloom_impl="take")
    assert m.cascade_model.bloom_impl() == "take"
    _assert_same(mj.match_arrays(docs), m.match_arrays(docs))
    with jax.disable_jit(False):
        hj = mj.device_corpus(docs, shard=True)
        with local_shards(len(jax.devices())):
            ht = m.device_corpus(docs, shard=True)
        assert ht.mesh is not None
        assert len(ht.mesh) == int(hj.mesh.devices.size) > 1
        _assert_same(mj.match_arrays_many([hj])[0],
                     m.match_arrays_many([ht])[0])
    with jax.disable_jit(False):
        mj, m = _matchers(pats, engine="kgram")
        assert m._pick_engine(sum(map(len, docs))) == "kgram"
        _assert_same(mj.match_arrays(docs), m.match_arrays(docs))
        mj, m = _matchers(pats, table_format="compressed")
        assert m.table_format == mj.table_format == "compressed"
        _assert_same(mj.match_arrays(docs), m.match_arrays(docs))


def test_alignment_gate_failure_raises():
    """A plan whose stride is no multiple of 4 cannot take the fused
    filter: the port serves it through the per-row filter, equal to the
    JAX package.  Where the same plan asks for the take filter, which
    once raised here, it takes the flat take filter, equal to the JAX
    package too."""
    rng = random.Random(3)
    pats = [bytes(rng.choice(b"abcdef") for _ in range(10))
            for _ in range(40)]
    mj, m = _matchers(pats)
    assert m.cascade_model.plan.stride % 4, m.cascade_model.plan.reason
    doc = b"abcdef" * 100 + pats[3] + b"fedcba" * 50 + pats[7]
    _assert_same(mj.match_arrays([doc]), m.match_arrays([doc]))
    assert m.match_arrays([doc])["doc"].shape[0] >= 2
    mj, m = _matchers(pats, bloom_impl="take")
    assert m.cascade_model.take_branch(1024) == "flat"
    got = m.match_arrays([doc])
    _assert_same(mj.match_arrays([doc]), got)
    assert got["doc"].shape[0] >= 2
