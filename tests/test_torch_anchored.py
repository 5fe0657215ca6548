"""The port's host-verify cascade branch against the JAX package's: the
anchored candidate filter (``filter_candidates``, its ``bloom_hit``
kernel) and sampled plans whose windows exceed 32 bytes, both verified
by the host walk of ``CascadeModel.verify_arrays``.

Every comparison is exact: kernel bits, candidate indices and counts bit
for bit, match records dict for dict.  The JAX side runs as its own CPU
tests run it: ``bloom_hit_pallas`` in interpret mode, its sampled filter
op by op under ``jax.disable_jit()``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import php_aho_corasick_tpu as ref  # noqa: E402
from php_aho_corasick_tpu.ops import filter_jax  # noqa: E402
from php_aho_corasick_tpu.ops.filter_pallas import (  # noqa: E402
    bloom_hit_pallas,
)

import php_aho_corasick_tpu_torch as port  # noqa: E402
from php_aho_corasick_tpu_torch.ops import filter_torch  # noqa: E402
from php_aho_corasick_tpu_torch.ops.filter_cuda import bloom_hit  # noqa: E402
from test_torch_rows import _needles, _planted_docs  # noqa: E402
from test_torch_slice import _assert_same  # noqa: E402

ABC = b"abcdef"
AZ = bytes(range(97, 123))


def _pair(specs, **cfg):
    cfg = dict(dict(backend="device", engine="cascade", auto_shard=False,
                    chunk_len=1024), **cfg)
    mj = ref.Matcher(specs, ref.ScanConfig(**cfg))
    mt = port.Matcher(specs, port.ScanConfig(**cfg), device="cpu")
    assert mt.cascade_model.plan.reason == mj.cascade_model.plan.reason
    return mj, mt


@pytest.mark.parametrize("W", [1024, 4096])
def test_bloom_hit_plain_matches_pallas(W):
    """The plain version (what the wrapper runs on a CPU tensor) against
    the Pallas kernel in interpret mode, over every bit position."""
    rng = np.random.default_rng(W)
    words = rng.integers(-(2**31), 2**31, W, dtype=np.int64).astype(np.int32)
    slots = rng.integers(0, W * 32, (3, 777)).astype(np.int32)
    slots[0, :32] = np.arange(32)  # bit 31 of word 0 included
    want = bloom_hit_pallas(jnp.asarray(words), jnp.asarray(slots),
                            interpret=True)
    before = bloom_hit.launches
    got = bloom_hit(torch.from_numpy(words), torch.from_numpy(slots))
    assert got.dtype == torch.int32 and got.shape == slots.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bloom_hit.launches == before  # CPU tensors launch nothing


@pytest.mark.parametrize("impl", ["pallas", "take"])
def test_filter_candidates_matches_jax(impl):
    """``filter_candidates`` (its ``bloom_hit`` probe) against the JAX
    function at each of its bloom probes, on a planned three-stage bloom
    with shorts, ragged rows and a capacity below and above the candidate
    count."""
    needles = _needles(300, 16, ABC, seed=2)
    specs = [{"value": p} for p in needles] + [{"value": b"ax"}]
    mj, mt = _pair(specs, cascade_mode="anchored")
    p = mt.cascade_model.plan
    assert p.mode == "anchored" and len(p.offsets) == 3 and p.shorts
    dev = mt.cascade_model.device_arrays
    rng = np.random.default_rng(4)
    B, L = 6, 1000
    chunks = rng.choice(np.frombuffer(ABC + b"x", np.uint8), (B, L))
    lengths = np.asarray([L, 0, 17, 999, 500, 1000], np.int32)
    emit = np.zeros(B, np.int32)
    for capacity in (64, 8192):
        kw = dict(n_classes=mt.automaton.n_classes, q=p.q, offsets=p.offsets,
                  log2_bits=p.log2_bits, salts=p.salts, shorts=p.shorts,
                  capacity=capacity)
        want = filter_jax.filter_candidates(
            jnp.asarray(p.bloom_words), jnp.asarray(dev["byte_class"].numpy()),
            jnp.asarray(dev["used_bytes"].numpy()), jnp.asarray(chunks),
            jnp.asarray(lengths), jnp.asarray(emit),
            jnp.int32(p.min_long_len), bloom_impl=impl, **kw)
        got = filter_torch.filter_candidates(
            dev["bloom_words"], dev["byte_class"], dev["used_bytes"],
            torch.from_numpy(chunks), torch.from_numpy(lengths),
            dev["min_long_len"], **kw)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert 64 < int(got[1]) <= 8192


@pytest.mark.parametrize("case", ["natural", "forced"])
def test_anchored_match_matches_jax(case):
    """``match_arrays`` columns, ``match_many`` dicts and ``match`` on an
    anchored plan, forced to the cascade, equal the JAX ``Matcher``'s:
    2048 x 7-byte needles plan it naturally (q=7, one stage); 16-byte
    needles under ``cascade_mode="anchored"`` give three stages.  The
    port probes through ``bloom_hit`` under either ``bloom_impl`` setting;
    the candidate capacity starts below the count, so every scan retries as
    the reference's does."""
    if case == "natural":
        needles, extra = _needles(2048, 7, ABC), {}
    else:
        needles, extra = _needles(300, 16, ABC, seed=2), dict(
            cascade_mode="anchored")
    extra["match_capacity"] = 256
    specs = [{"id": i, "value": p} for i, p in enumerate(needles)]
    specs.append({"key": "s", "value": b"fa"})
    docs = _planted_docs(needles, 10, 6000, 5, seed=3, alphabet=ABC,
                         min_len=3000)
    mj, _ = _pair(specs, **extra)
    assert mj.cascade_model.plan.mode == "anchored"
    want = mj.match_arrays(docs)
    want_d = mj.match_many(docs)
    for impl in ("auto", "pallas"):
        _, mt = _pair(specs, bloom_impl=impl, **extra)
        cm = mt.cascade_model
        assert cm.bloom_impl() == "pallas"
        h = mt.device_corpus(docs)
        _assert_same(want, mt.match_arrays(h))
        _assert_same(want, mt.match_arrays(docs))
        assert mt.match_many(docs) == want_d
        assert mt.match(docs[0]) == want_d[0]
        # the pipelined batch serves it sequentially, and says so
        for got in mt.match_arrays_many([h, h]):
            _assert_same(want, got)
        assert mt.stats.records_fallback_reason == "plan mode 'anchored'"
    assert want["doc"].shape[0] >= 50
    if case == "natural":
        plan = cm.plan
        assert (plan.q, plan.offsets, plan.log2_bits) == (7, (0,), 17)
        _, n = cm.candidates_np(h.packed, mt.config.match_capacity)
        assert n > mt.config.match_capacity


def test_long_window_sampled_set_matches_jax():
    """20-byte needles over ``a-z`` plan stride 16 with 35-byte windows,
    over the records gate: the port's fused filter, host expansion and
    host verify equal the JAX ``Matcher``'s, resident and not."""
    needles = _needles(200, 20, AZ, seed=6)
    specs = [{"id": i, "value": p} for i, p in enumerate(needles)]
    mj, mt = _pair(specs, bloom_impl="pallas_vmem")
    cm = mt.cascade_model
    assert cm.plan.mode == "sampled" and cm.plan.stride == 16
    assert cm.win_len > 32 and not cm.device_verify_ok
    docs = _planted_docs(needles, 8, 5000, 4, seed=8, alphabet=AZ,
                         min_len=2500)
    with jax.disable_jit():
        want = mj.match_arrays(docs)
    h = mt.device_corpus(docs)
    assert h.fused_phases(cm) is not None
    _assert_same(want, mt.match_arrays(h))
    _assert_same(want, mt.match_arrays(docs))
    assert mt.stats.records_fallbacks == 0
    mt.match_arrays_many([h])
    assert "records gate" in mt.stats.records_fallback_reason
    assert want["doc"].shape[0] >= 8 * 3
