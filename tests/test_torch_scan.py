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


def _ac_automaton(seed, n_letters, n_patterns, long_len=0):
    """An Aho-Corasick DFA the port builds: ``n_patterns`` random patterns
    of 1-8 letters from the first ``n_letters`` of ``a-z`` (plus one of
    ``long_len`` letters); returns it, the letters and its longest
    pattern."""
    from php_aho_corasick_tpu_torch import Matcher, ScanConfig

    rng = np.random.default_rng(seed)
    letters = np.arange(97, 97 + n_letters, dtype=np.uint8)
    pats = {rng.choice(letters, rng.integers(1, 9)).tobytes()
            for _ in range(n_patterns)}
    if long_len:
        pats.add(rng.choice(letters, long_len).tobytes())
    m = Matcher([{"value": p} for p in sorted(pats)],
                ScanConfig(backend="device"), device="cpu")
    return m.automaton, letters, max(pats, key=len)


AC_SETS = [
    (1, 2, 6, 0),
    (2, 3, 20, 0),
    (3, 4, 40, 0),
    (4, 5, 60, 0),
    (5, 6, 40, 30),
    # near the tile bound: S * C = 4004 of 4096, one 380-letter pattern
    (6, 6, 60, 380),
]


def _walk(auto, states, text_classes):
    for c in text_classes:
        states = auto.lookup(states, c)
    return states


@pytest.mark.parametrize("seed,n_letters,n_patterns,long_len", AC_SETS)
def test_ac_state_resynchronises_after_max_len(seed, n_letters, n_patterns,
                                               long_len):
    """The property the segmented tile walk rests on: after ``max_len``
    bytes an Aho-Corasick DFA's state no longer depends on where the walk
    started, so at every offset ``o >= max_len`` the walk from root over
    ``[o - max_len, o)`` equals the full walk from any initial state."""
    auto, letters, _ = _ac_automaton(seed, n_letters, n_patterns, long_len)
    S, C = auto.n_states, auto.n_classes
    if seed == 6:
        assert 4000 <= S * C <= 4096 and auto.max_len == 380
    rng = np.random.default_rng(seed + 100)
    n_rows, L = 16, auto.max_len + 40
    pool = np.concatenate([letters, [0x20]])  # a byte of no pattern too
    text = rng.choice(pool, (n_rows, L)).astype(np.uint8)
    cls = auto.byte_class[text]
    full = rng.integers(0, S, n_rows).astype(np.int64)
    states = np.empty((n_rows, L), np.int64)
    for t in range(L):
        full = auto.lookup(full, cls[:, t])
        states[:, t] = full
    M = auto.max_len
    for o in range(M, L + 1):
        root = _walk(auto, np.zeros(n_rows, np.int64), cls[:, o - M : o].T)
        np.testing.assert_array_equal(root, states[:, o - 1])


def _segmented_walk(auto, chunks, init, lengths, sync_len):
    """Numpy model of the CUDA tile kernel under the wrapper's segment
    plan: segment 0 from ``init``, segment k >= 1 from state 0 over the
    ``warm`` bytes before it; the carry from the segment holding the last
    valid byte."""
    from php_aho_corasick_tpu_torch.ops.scan_cuda import tile_segment_plan

    B, L = chunks.shape
    seg_len, n_seg, warm = tile_segment_plan(L, sync_len)
    assert seg_len * n_seg >= L and (n_seg == 1 or warm <= seg_len // 4)
    cls = auto.byte_class[chunks]
    states = np.full((B, L), -1, np.int64)
    carry = np.asarray(init, np.int64).copy()
    for k in range(n_seg):
        t0, t1 = k * seg_len, min(L, (k + 1) * seg_len)
        if k == 0:
            s = np.asarray(init, np.int64).copy()
        else:
            assert t0 - warm >= 0
            s = _walk(auto, np.zeros(B, np.int64), cls[:, t0 - warm : t0].T)
        for t in range(t0, t1):
            s = auto.lookup(s, cls[:, t])
            states[:, t] = s
            carry = np.where(lengths - 1 == t, s, carry)
    return states, carry


@pytest.mark.parametrize(
    "set_i,B,L,sync",
    [
        (2, 9, 300, "max_len"),  # L % 16 != 0: a short last segment
        (3, 7, 64 * 5, "max_len"),  # whole segments
        (5, 5, 400, "max_len"),  # 30-byte pattern: 32-byte warm-up
        (6, 3, 3300, "max_len"),  # 380-byte pattern: 1536-byte segments
        (6, 3, 250, "max_len"),  # L < sync_len: one segment
        (4, 6, 500, None),  # no sync_len: one segment
        (1, 4, 0, "max_len"),  # no bytes: carry = init
    ],
)
def test_segmented_tile_walk_equals_plain(set_i, B, L, sync):
    """The segment plan with ``sync_len = max_len`` on an Aho-Corasick
    DFA gives the plain walk's states and carry, for ragged, empty and
    full rows and nonzero initial states."""
    from php_aho_corasick_tpu_torch.ops.scan_cuda import tile_segment_plan

    auto, letters, longest = _ac_automaton(*AC_SETS[set_i - 1])
    sync_len = auto.max_len if sync == "max_len" else None
    seg_len, n_seg, warm = tile_segment_plan(L, sync_len)
    if (set_i, L) in ((3, 320), (2, 300), (5, 400), (6, 3300)):
        assert n_seg > 1
    if sync is None or L <= 4 * auto.max_len:
        assert n_seg == 1
    rng = np.random.default_rng(set_i * 1000 + L)
    pool = np.concatenate([letters, [0x20]])
    chunks = rng.choice(pool, (B, L)).astype(np.uint8)
    # the longest pattern ending just past every segment boundary: a
    # warm-up shorter than it would lose the match
    n = len(longest)
    for k in range(1, n_seg):
        o = k * seg_len - n + 2
        if 0 <= o <= L - n:
            chunks[:, o : o + n] = np.frombuffer(longest, np.uint8)
    init = rng.integers(0, auto.n_states, B).astype(np.int32)
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[0], lengths[-1] = 0, L
    got_s, got_c = _segmented_walk(auto, chunks, init, lengths, sync_len)
    t = torch.from_numpy
    want_s, want_c = _scan_states_tile_torch(
        t(auto.table.reshape(-1).astype(np.int32)),
        t(auto.byte_class.astype(np.int32)), t(auto.used_bytes),
        t(chunks), t(init), auto.n_classes, t(lengths),
    )
    np.testing.assert_array_equal(got_s, want_s.numpy())
    np.testing.assert_array_equal(got_c, want_c.numpy())


@pytest.mark.parametrize(
    "L,sync_len,want",
    [
        (2176, 8, (64, 34, 16)),  # the tile cell: the probe set's 8 bytes
        (2176, None, (2176, 1, 0)),
        (2176, 0, (64, 34, 0)),  # the empty automaton: no warm-up
        (2176, 17, (128, 17, 32)),
        (1000, 300, (1000, 1, 0)),  # a segment would cover the row
        (64, 3, (64, 1, 0)),
        (0, 5, (0, 1, 0)),
    ],
)
def test_tile_segment_plan(L, sync_len, want):
    from php_aho_corasick_tpu_torch.ops.scan_cuda import tile_segment_plan

    assert tile_segment_plan(L, sync_len) == want
