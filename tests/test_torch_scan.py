"""The port's DFA scans against the JAX package's, bit for bit: the dense
walk (``scan_states``, ``scan_and_compact``, ``compact_final_states``) and
the tile kernel's plain version against ``scan_states_tile`` in interpret
mode.  Inputs are made with numpy from a seed and handed to both."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from php_aho_corasick_tpu.ops import scan_jax  # noqa: E402
from php_aho_corasick_tpu.ops.scan_pallas import (  # noqa: E402
    scan_states_tile as jax_scan_states_tile,
)

from php_aho_corasick_tpu_torch.ops import scan_torch  # noqa: E402
from php_aho_corasick_tpu_torch.ops.scan_cuda import (  # noqa: E402
    _scan_states_tile_torch,
    scan_states_tile,
)


def _dfa_case(seed, S, U, B, L, dtype, short_rows=True):
    """A random DFA over ``U`` used bytes (``S`` states, ``C = U + 1``
    classes, states ``>= final_start`` final) and ``[B, L]`` rows of bytes
    drawn mostly from the used ones; rows get random lengths, some 0."""
    rng = np.random.default_rng(seed)
    C = U + 1
    used = np.sort(rng.choice(256, U, replace=False)).astype(np.uint8)
    byte_class = np.zeros(256, np.int32)
    byte_class[used] = np.arange(1, U + 1)
    table = rng.integers(0, S, S * C).astype(dtype)
    pool = np.concatenate([used, rng.integers(0, 256, max(U // 3, 1))])
    chunks = rng.choice(pool, (B, L)).astype(np.uint8)
    if short_rows:
        lengths = rng.integers(0, L + 1, B).astype(np.int32)
        lengths[:: max(B // 3, 2)] = 0
        lengths[1::7] = L
    else:
        lengths = np.full(B, L, np.int32)
    emit_from = np.minimum(rng.integers(0, 9, B), lengths).astype(np.int32)
    init = rng.integers(0, S, B).astype(np.int32)
    final_start = np.int32(S - max(S // 6, 1))
    return dict(table=table, byte_class=byte_class, used=used,
                chunks=chunks, lengths=lengths, emit_from=emit_from,
                init=init, final_start=final_start, C=C)


def _both(case, *names):
    j = tuple(jnp.asarray(case[n]) for n in names)
    t = tuple(torch.from_numpy(np.asarray(case[n])) for n in names)
    return j, t


ARGS = ("table", "byte_class", "used", "chunks", "init")


@pytest.mark.parametrize(
    "S,U,B,L,dtype",
    [
        (40, 5, 24, 300, np.int16),  # compare-select classes
        (300, 40, 9, 130, np.int32),  # byte_class gather (> 32 used bytes)
        (7, 1, 5, 1, np.int16),
    ],
)
def test_scan_states_matches_jax(S, U, B, L, dtype):
    case = _dfa_case(S + U, S, U, B, L, dtype)
    (tj, bj, uj, cj, ij), (tt, bt, ut, ct, it) = _both(case, *ARGS)
    want_s, want_last = scan_jax.scan_states(tj, bj, uj, cj, ij, case["C"])
    got_s, got_last = scan_torch.scan_states(tt, bt, ut, ct, it, case["C"])
    assert got_s.dtype == torch.int32 and tuple(got_s.shape) == (B, L)
    np.testing.assert_array_equal(np.asarray(want_s), got_s.numpy())
    np.testing.assert_array_equal(np.asarray(want_last), got_last.numpy())


@pytest.mark.parametrize(
    "S,U,capacity,dtype",
    [
        (60, 6, 512, np.int16),  # fits: direct compaction
        (60, 6, 16, np.int16),  # overflow: n is the true count
        (500, 36, 64, np.int32),  # blocked compaction, gather classes
        (500, 36, 7, np.int32),
    ],
)
def test_scan_and_compact_matches_jax(S, U, capacity, dtype):
    case = _dfa_case(S * 7 + capacity, S, U, 40, 256, dtype)
    (tj, bj, uj, cj, ij), (tt, bt, ut, ct, it) = _both(case, *ARGS)
    (lj, ej, fj), (lt, et, ft) = _both(
        case, "lengths", "emit_from", "final_start"
    )
    assert int(case["emit_from"].max()) > 0
    want = scan_jax.scan_and_compact(
        tj, bj, uj, cj, ij, lj, ej, fj, n_classes=case["C"],
        capacity=capacity,
    )
    got = scan_torch.scan_and_compact(
        tt, bt, ut, ct, it, lt, et, ft, n_classes=case["C"],
        capacity=capacity,
    )
    for a, b in zip(want, got):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    n = int(got[2])
    assert n > 0
    if capacity == 16:
        assert n > capacity  # the overflow reports the true count


def test_compact_final_states_matches_jax():
    rng = np.random.default_rng(5)
    B, L = 33, 200
    states = rng.integers(0, 100, (B, L)).astype(np.int32)
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    emit_from = rng.integers(0, 30, B).astype(np.int32)
    for fs, cap in ((95, 64), (95, 8), (60, 4096)):
        want = scan_jax.compact_final_states(
            jnp.asarray(states), jnp.asarray(lengths), jnp.asarray(emit_from),
            jnp.int32(fs), cap,
        )
        got = scan_torch.compact_final_states(
            torch.from_numpy(states), torch.from_numpy(lengths),
            torch.from_numpy(emit_from), torch.tensor(fs, dtype=torch.int32),
            cap,
        )
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize(
    "S,U,B,L,lengths",
    [
        (50, 5, 1029, 70, True),  # B not a multiple of 1024, short rows
        (30, 3, 6, 1100, True),  # L > 1024: crosses a time block
        (40, 4, 9, 100, False),  # no lengths: carry = states[:, -1]
    ],
)
def test_tile_plain_matches_jax_kernel(S, U, B, L, lengths):
    """The tile kernel's plain version against the Pallas kernel in
    interpret mode: states and carry bit for bit."""
    case = _dfa_case(S * B + L, S, U, B, L, np.int16)
    (tj, bj, uj, cj, ij), (tt, bt, ut, ct, it) = _both(case, *ARGS)
    (lj,), (lt,) = _both(case, "lengths")
    want = jax_scan_states_tile(
        tj, bj, uj, cj, ij, n_classes=case["C"],
        lengths=lj if lengths else None, interpret=True,
    )
    got = _scan_states_tile_torch(
        tt, bt, ut, ct, it, case["C"], lt if lengths else None
    )
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    if lengths:  # short rows: the carry is the last valid byte's state
        short = (case["lengths"] > 0) & (case["lengths"] < L)
        assert short.any() and (case["lengths"] == 0).any()
        rows = np.nonzero(short)[0]
        np.testing.assert_array_equal(
            got[1].numpy()[rows],
            got[0].numpy()[rows, case["lengths"][rows] - 1],
        )


def test_tile_wrapper_on_cpu_runs_plain():
    case = _dfa_case(3, 20, 4, 8, 64, np.int16)
    _, (tt, bt, ut, ct, it) = _both(case, *ARGS)
    lt = torch.from_numpy(case["lengths"])
    before = scan_states_tile.launches
    got = scan_states_tile(tt, bt, ut, ct, it, case["C"], lengths=lt)
    want = _scan_states_tile_torch(tt, bt, ut, ct, it, case["C"], lt)
    assert scan_states_tile.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("U", [1, 6, 32, 33, 200])
def test_byte_class_equals_compare_select(U):
    """The kernel classifies through the 256-entry ``byte_class`` map; that
    equals the reference's compare-select because ``byte_class[used[i]]
    == i + 1`` and 0 elsewhere."""
    case = _dfa_case(U, 10, U, 4, 256, np.int16)
    chunks = torch.arange(256, dtype=torch.int32).to(torch.uint8)[None]
    chunks = torch.cat([chunks, torch.from_numpy(case["chunks"][:, :256])])
    used = torch.from_numpy(case["used"])
    bc = torch.from_numpy(case["byte_class"])
    select = scan_torch.classify_bytes(chunks, used)
    assert torch.equal(bc[chunks.long()], select)
    assert torch.equal(scan_torch._classes(chunks, bc, used), select)
