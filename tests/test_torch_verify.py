"""The port's record verifiers against the JAX package's, bit for bit, on
the same automaton, corpus and grid hits (CPU)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from php_aho_corasick_tpu.core import TrieBuilder, compile_trie  # noqa: E402
from php_aho_corasick_tpu.ops import filter_jax as fj  # noqa: E402
from php_aho_corasick_tpu_torch.ops import filter_torch as ft  # noqa: E402

INT32_MAX = 2**31 - 1
STRIDE = 8


def _automaton(patterns):
    tb = TrieBuilder(1024)
    for p in patterns:
        tb.add(p)
    return compile_trie(tb, [len(p) for p in patterns])


def _table2(auto):
    t = np.ascontiguousarray(auto.table, dtype=np.int64)
    S, C = t.shape
    s2 = t[t.reshape(-1), :].reshape(S, C, C)
    return (s2 | (t[:, :, None] << fj.REC2_BITS)).astype(np.int32).reshape(-1)


def _case(seed, B, L, H):
    """A corpus over ``abcd`` with planted patterns, one run of ``a``s
    (more than VERIFY_KR finals in one window), ragged lengths and
    emit_from, and ``H`` grid hits: every cell of row 0, then random
    cells, INT32_MAX padded."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"abcd", np.uint8)
    patterns = [rng.choice(alphabet, rng.integers(4, 13)).tobytes()
                for _ in range(30)]
    patterns = list(dict.fromkeys(patterns + [b"aaaa", b"aaaaa"]))
    auto = _automaton(patterns)
    chunks = rng.choice(alphabet, (B, L))
    for _ in range(4 * B):
        p = patterns[rng.integers(len(patterns))]
        b, o = rng.integers(B), rng.integers(L - len(p))
        chunks[b, o : o + len(p)] = np.frombuffer(p, np.uint8)
    chunks[0, 40:72] = ord("a")
    lengths = np.full(B, L, np.int32)
    lengths[1::3] = rng.integers(L // 2, L, len(lengths[1::3]))
    emit_from = np.zeros(B, np.int32)
    emit_from[2::4] = 11
    M = L // STRIDE
    m0 = min(M, H // 2)
    cells = np.concatenate([
        np.arange(m0), rng.choice(np.arange(M, B * M), H - m0 - 20,
                                  replace=False),
    ]).astype(np.int32)
    grid_idx = np.full(H, INT32_MAX, np.int32)
    grid_idx[: cells.shape[0]] = rng.permutation(cells)
    win_len = STRIDE - 1 + auto.max_len
    return auto, chunks, lengths, emit_from, grid_idx, win_len


@pytest.mark.parametrize(
    "B,L,capacity",
    [
        (16, 256, 4096),  # JAX takes its packed-class window fetch
        (64, 4096, 4096),  # JAX takes its byte-gather window fetch
        (16, 256, 48),  # n_rec > capacity: the overflow contract
    ],
)
@pytest.mark.parametrize("two_step", [True, False])
def test_verify_windows_records(B, L, capacity, two_step):
    H = 256
    auto, chunks, lengths, emit_from, grid_idx, W = _case(B + L, B, L, H)
    C = auto.n_classes
    table = _table2(auto) if two_step else np.ascontiguousarray(
        auto.table).reshape(-1)
    used = auto.used_bytes
    bc = auto.byte_class.astype(np.int32)
    kw = dict(n_classes=C, stride=STRIDE, win_len=W, capacity=capacity,
              n_hits=H)
    jax_fn = fj.verify_windows_records2 if two_step else (
        fj.verify_windows_records)
    want = jax_fn(
        jnp.asarray(table), jnp.asarray(bc), jnp.asarray(used),
        jnp.asarray(chunks), jnp.asarray(lengths), jnp.asarray(emit_from),
        jnp.asarray(grid_idx), jnp.int32(auto.final_start), **kw,
    )
    t = torch.from_numpy
    port_fn = ft.verify_windows_records2 if two_step else (
        ft.verify_windows_records)
    got = port_fn(
        t(table), t(bc), t(used), t(chunks), t(lengths), t(emit_from),
        t(grid_idx), torch.tensor(auto.final_start, dtype=torch.int32), **kw,
    )
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    rc, rp, nr = (x.numpy() for x in got)
    assert nr > 0
    if capacity < 100:
        assert int(nr) > capacity
    else:  # the run of 'a's overflowed a window's record slots
        assert ((rp[: int(nr)] & 31) == ft.REC_OVERFLOW_J).any()
