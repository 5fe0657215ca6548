"""A forced capacity retry on the serving path, port against the JAX
package: small seeded caps and densely planted needles make the filter,
verify and per-column slot capacities overflow and retry, and both
packages must converge to the same caps and results."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import php_aho_corasick_tpu as ref  # noqa: E402

import php_aho_corasick_tpu_torch as port  # noqa: E402

CFG = dict(backend="device", engine="cascade", bloom_impl="pallas_vmem",
           auto_shard=False, chunk_len=1024)


@pytest.fixture(autouse=True)
def _jax_eager():
    """Run the JAX side op by op: at these sizes XLA's compile of its
    unrolled mirror costs far more than the work, and the results are
    the same."""
    with jax.disable_jit():
        yield


def _needles():
    """``bench.py``'s headline set: 2048 needles x 16 bytes over abcdef."""
    rng = random.Random(1337)
    needles = set()
    while len(needles) < 2048:
        needles.add(bytes(rng.choice(b"abcdef") for _ in range(16)))
    return sorted(needles)


def test_capacity_retry_matches_jax():
    """Small seeded caps and densely planted needles: the filter, verify
    and per-column slot capacities all overflow and retry."""
    needles = _needles()
    rng = random.Random(7)
    docs = []
    for _ in range(128):  # one unpadded 1 KiB row each
        d = bytearray(rng.choice(b"abcdef") for _ in range(1024))
        for _ in range(4):
            o = rng.randrange(1024 - 16)
            d[o : o + 16] = needles[rng.randrange(len(needles))]
        docs.append(bytes(d))
    specs = [{"id": i, "value": p} for i, p in enumerate(needles)]
    mj = ref.Matcher(specs, ref.ScanConfig(**CFG))
    mt = port.Matcher(specs, port.ScanConfig(**CFG), device="cpu")
    for m in (mj, mt):
        cm = m.cascade_model
        cm._cap_hits = cm._cap_flagged = 256
        cm._cap_coarse = cm._cap_coarse_floor = 8
    res_j = mj.match_arrays_many([mj.device_corpus(docs)])[0]
    res_t = mt.match_arrays_many([mt.device_corpus(docs)])[0]
    for k in res_j:
        np.testing.assert_array_equal(res_j[k], res_t[k], err_msg=k)
    assert res_t["doc"].shape[0] >= 128 * 3
    assert mt.stats.capacity_retries == mj.stats.capacity_retries >= 3
    assert mt.cascade_model._cap_coarse == mj.cascade_model._cap_coarse > 8
    assert mt.cascade_model.learned_caps == mj.cascade_model.learned_caps
