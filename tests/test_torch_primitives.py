"""The port's tensor primitives against the JAX package's, bit for bit,
on the same numpy inputs (CPU)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from php_aho_corasick_tpu.ops import filter_jax as fj  # noqa: E402
from php_aho_corasick_tpu.ops import scan_jax as sj  # noqa: E402
from php_aho_corasick_tpu_torch.ops import filter_torch as ft  # noqa: E402
from php_aho_corasick_tpu_torch.ops import scan_torch as st  # noqa: E402


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("n_used", [6, 40])
def test_classes(n_used):
    """Compare-select (<= 32 used bytes) and table-lookup classification."""
    rng = np.random.default_rng(n_used)
    used = np.sort(rng.choice(256, n_used, replace=False)).astype(np.uint8)
    byte_class = np.zeros(256, np.int32)
    byte_class[used] = np.arange(1, n_used + 1)
    chunks = rng.integers(0, 256, (16, 96)).astype(np.uint8)
    chunks[:, ::3] = rng.choice(used, (16, 32))
    want = sj._classes(jnp.asarray(chunks), jnp.asarray(byte_class),
                       jnp.asarray(used))
    got = st._classes(torch.from_numpy(chunks), torch.from_numpy(byte_class),
                      torch.from_numpy(used))
    _eq(want, got)


@pytest.mark.parametrize(
    "n,capacity,density",
    [
        (4000, 600, 0.05),  # direct: capacity * blk >= n
        (20_000, 200, 0.005),  # one block level
        (400_000, 200, 0.0003),  # recursive pyramid (nb > 16 * capacity)
        (400_000, 64, 0.001),  # overflow: n_true > capacity
        (20_000, 200, 0.02),  # overflow in the one-level regime
        (3000, 500, 0.5),  # overflow in the direct regime
    ],
)
def test_blocked_nonzero(n, capacity, density):
    rng = np.random.default_rng(n + capacity)
    flat = rng.random(n) < density
    idx_j, n_j = sj.blocked_nonzero(jnp.asarray(flat), capacity)
    idx_t, n_t = st.blocked_nonzero(torch.from_numpy(flat), capacity)
    _eq(idx_j, idx_t)
    assert idx_t.dtype == torch.int32 and n_t.dtype == torch.int32
    assert int(n_j) == int(n_t) == int(flat.sum())


def test_pack_corpus_words_and_phase_grid():
    rng = np.random.default_rng(7)
    chunks = rng.integers(0, 256, (24, 384)).astype(np.uint8)
    _eq(fj.pack_corpus_words(jnp.asarray(chunks)),
        ft.pack_corpus_words(torch.from_numpy(chunks)))
    for spc, block_r in ((2, 8), (1, 16), (4, 1024)):
        want = fj.fused_phase_grid(jnp.asarray(chunks), spc=spc,
                                   block_r=block_r)
        got = ft.fused_phase_grid(torch.from_numpy(chunks), spc=spc,
                                  block_r=block_r)
        assert got.shape == (spc,) + tuple(want[0].shape)
        for p in range(spc):
            _eq(want[p], got[p])


@pytest.mark.parametrize("stride", [8, 32])
def test_short_start_words(stride):
    rng = np.random.default_rng(stride)
    B, L = 8, 256
    chunks = rng.choice(np.frombuffer(b"abxyq", np.uint8), (B, L))
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    shorts = (b"xy", b"q", b"abx")
    M = -(-L // stride)
    want = fj._short_start_words(jnp.asarray(chunks), jnp.asarray(lengths),
                                 shorts, stride, M)
    got = ft._short_start_words(torch.from_numpy(chunks),
                                torch.from_numpy(lengths), shorts, stride, M)
    _eq(want, got)
    if stride == 32:  # bit 31 set somewhere: the int32 sign bit
        assert (got.numpy() < 0).any()


def test_hash_helpers_wrap_like_uint32():
    rng = np.random.default_rng(3)
    x = rng.integers(-(2**31), 2**31, 5000, dtype=np.int64).astype(np.int32)
    salt = 0x9E3779B9
    want = ((x.view(np.uint32) ^ np.uint32(salt)) * np.uint32(ft.KNUTH)) >> 20
    got = ft.mul32(ft.u32(torch.from_numpy(x)) ^ salt, ft.KNUTH) >> 20
    np.testing.assert_array_equal(want.astype(np.int64), got.numpy())
    np.testing.assert_array_equal(
        ft.to_i32(ft.u32(torch.from_numpy(x))).numpy(), x
    )
