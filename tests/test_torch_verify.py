"""The port's record verifiers against the JAX package's, bit for bit, on
the same automaton, corpus and grid hits (CPU); the ``verify_records``
wrapper's routing, input checks and build entry (CPU); and its kernel
against the plain version on the same cases (card).

The file imports JAX only inside the tests that compare with it, so on a
machine with a card and without JAX its card tests run on their own:

    python -m pytest --noconftest -m cuda tests/test_torch_verify.py
"""

import importlib.util
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from php_aho_corasick_tpu_torch.core import (  # noqa: E402
    TrieBuilder,
    compile_trie,
)
from php_aho_corasick_tpu_torch.ops import _build  # noqa: E402
from php_aho_corasick_tpu_torch.ops import filter_cuda as fc  # noqa: E402
from php_aho_corasick_tpu_torch.ops import filter_torch as ft  # noqa: E402

INT32_MAX = 2**31 - 1
STRIDE = 8
H = 256

#: (B, L, capacity): the JAX package's packed-class window fetch, its
#: byte-gather fetch, and ``n_rec > capacity`` (the overflow contract)
SHAPES = [(16, 256, 4096), (64, 4096, 4096), (16, 256, 48)]
#: (step, table dtype): the dense table in both widths, the 2-step table
TABLES = [(1, np.int16), (1, np.int32), (2, np.int32)]
#: grid hits as drawn; ``n_hits`` past the hit array (the array's length
#: bounds the slots); every slot padding
GRIDS = ["drawn", "n_hits_over", "all_padding"]


def _automaton(patterns):
    tb = TrieBuilder(1024)
    for p in patterns:
        tb.add(p)
    return compile_trie(tb, [len(p) for p in patterns])


def _table2(auto):
    t = np.ascontiguousarray(auto.table, dtype=np.int64)
    S, C = t.shape
    s2 = t[t.reshape(-1), :].reshape(S, C, C)
    return (s2 | (t[:, :, None] << ft.REC2_BITS)).astype(np.int32).reshape(-1)


def _case(seed, B, L, H, alphabet=b"abcd"):
    """A corpus over ``alphabet`` with planted patterns, one run of ``a``s
    (more than VERIFY_KR finals in one window), ragged lengths and
    emit_from, and ``H`` grid hits: every cell of row 0, then random
    cells, INT32_MAX padded."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(alphabet, np.uint8)
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


def _inputs(B, L, capacity, step, dtype, grid, alphabet=b"abcd"):
    """The numpy arguments and keywords of one verify call."""
    auto, chunks, lengths, emit_from, grid_idx, W = _case(B + L, B, L, H,
                                                          alphabet)
    if step == 2:
        table = _table2(auto)
    else:
        table = np.ascontiguousarray(auto.table).reshape(-1).astype(dtype)
    n_hits = H
    if grid == "n_hits_over":
        n_hits = H + 100
    elif grid == "all_padding":
        grid_idx = np.full(H, INT32_MAX, np.int32)
    args = (table, auto.byte_class.astype(np.int32), auto.used_bytes, chunks,
            lengths, emit_from, grid_idx, np.int32(auto.final_start))
    kw = dict(n_classes=auto.n_classes, stride=STRIDE, win_len=W,
              capacity=capacity, n_hits=n_hits)
    return args, kw


def _torch_args(args, device="cpu"):
    *arrays, fs = args
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays) + (
        torch.tensor(int(fs), dtype=torch.int32, device=device),)


def _port(args, kw, step, device="cpu"):
    fn = ft.verify_windows_records2 if step == 2 else ft.verify_windows_records
    return fn(*_torch_args(args, device), **kw)


def _jax(args, kw, step):
    import jax.numpy as jnp

    from php_aho_corasick_tpu.ops import filter_jax as fj

    fn = fj.verify_windows_records2 if step == 2 else fj.verify_windows_records
    *arrays, fs = args
    return fn(*(jnp.asarray(a) for a in arrays), jnp.int32(fs), **kw)


def _assert_records(got, want):
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.cpu().numpy())


def _check_shape(got, capacity, grid):
    rc, rp, nr = (x.cpu().numpy() for x in got)
    if grid == "all_padding":
        assert int(nr) == 0 and (rc == INT32_MAX).all() and (rp == 0).all()
        return
    assert nr > 0
    if capacity < 100:
        assert int(nr) > capacity
    else:  # the run of 'a's overflowed a window's record slots
        assert ((rp[: int(nr)] & 31) == ft.REC_OVERFLOW_J).any()


@pytest.mark.parametrize("B,L,capacity", SHAPES)
@pytest.mark.parametrize("two_step", [True, False])
def test_verify_windows_records(B, L, capacity, two_step):
    pytest.importorskip("jax")
    step = 2 if two_step else 1
    args, kw = _inputs(B, L, capacity, step, np.int16, "drawn")
    got = _port(args, kw, step)
    _assert_records(got, _jax(args, kw, step))
    _check_shape(got, capacity, "drawn")


@pytest.mark.parametrize("grid", GRIDS[1:])
@pytest.mark.parametrize("step,dtype", TABLES)
def test_verify_windows_records_tables_and_grids(step, dtype, grid):
    """Both table widths of the 1-step walk, the 2-step table, ``n_hits``
    past the hit array and an all-padding hit array, against JAX."""
    pytest.importorskip("jax")
    args, kw = _inputs(16, 256, 48, step, dtype, grid)
    got = _port(args, kw, step)
    _assert_records(got, _jax(args, kw, step))
    _check_shape(got, 48, grid)


def test_verify_windows_records_int32_table():
    pytest.importorskip("jax")
    args, kw = _inputs(64, 4096, 4096, 1, np.int32, "drawn")
    got = _port(args, kw, 1)
    _assert_records(got, _jax(args, kw, 1))


#: more used bytes than compare-select classifies (``CLASSIFY_SELECT_LIMIT``
#: 32): classes come from the ``byte_class`` gather
WIDE = bytes(range(ord("a"), ord("a") + 48))


@pytest.mark.parametrize("step", [1, 2])
def test_verify_windows_records_byte_class_gather(step):
    pytest.importorskip("jax")
    args, kw = _inputs(16, 256, 4096, step, np.int32, "drawn", WIDE)
    assert args[2].shape[0] > 32
    got = _port(args, kw, step)
    _assert_records(got, _jax(args, kw, step))
    assert int(got[2]) > 0


@pytest.mark.parametrize("step", [1, 2])
def test_wrapper_routes_cpu_tensors_to_plain_loop(step, monkeypatch):
    """On CPU tensors the entry point goes through the wrapper, which runs
    the plain loop and launches nothing."""
    args, kw = _inputs(16, 256, 4096, step, np.int16, "drawn")
    seen = []
    real = fc.verify_records

    def spy(*a, **k):
        seen.append(k["step"])
        return real(*a, **k)

    monkeypatch.setattr(fc, "verify_records", spy)
    before = real.launches
    got = _port(args, kw, step)
    assert seen == [step] and real.launches == before
    want = ft._verify_records_torch(*_torch_args(args), **kw, step=step)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _good_inputs():
    args, kw = _inputs(16, 256, 48, 1, np.int16, "drawn")
    tensors = dict(zip(
        ("table", "byte_class", "used_bytes", "chunks", "lengths",
         "emit_from", "grid_idx", "final_start"), _torch_args(args)))
    del tensors["used_bytes"]  # the kernel classifies by byte_class alone
    kw = dict(kw, step=1)
    kw.pop("n_hits")
    return tensors, kw


BAD_INPUTS = {
    "table_int64": (dict(table=lambda t: t.long()), {}, TypeError),
    "int16_two_step": ({}, dict(step=2), TypeError),
    "table_2d": (dict(table=lambda t: t[None, :]), {}, ValueError),
    "byte_class_short": (dict(byte_class=lambda t: t[:128]), {}, ValueError),
    "byte_class_int64": (dict(byte_class=lambda t: t.long()), {}, TypeError),
    "chunks_int32": (dict(chunks=lambda t: t.int()), {}, TypeError),
    "chunks_strided": (dict(chunks=lambda t: t[:, ::2]), {}, ValueError),
    "chunks_1d": (dict(chunks=lambda t: t.reshape(-1)), {}, ValueError),
    "lengths_short": (dict(lengths=lambda t: t[:-1]), {}, ValueError),
    "emit_from_int64": (dict(emit_from=lambda t: t.long()), {}, TypeError),
    "grid_idx_int64": (dict(grid_idx=lambda t: t.long()), {}, TypeError),
    "final_start_two": (dict(final_start=lambda t: t.repeat(2)), {},
                        ValueError),
    "win_len_32": ({}, dict(win_len=32), ValueError),
    "step_3": ({}, dict(step=3), ValueError),
    "capacity_0": ({}, dict(capacity=0), ValueError),
}


@pytest.mark.parametrize("name", sorted(BAD_INPUTS))
def test_check_verify_inputs_raises(name):
    """What the kernel does not take raises before any launch (the checks
    need no card: they run on CPU tensors here)."""
    tensors, kw = _good_inputs()
    fc.check_verify_inputs(**tensors, **kw)  # the good inputs pass
    edit, kw_edit, exc = BAD_INPUTS[name]
    for k, f in edit.items():
        tensors[k] = f(tensors[k])
    with pytest.raises(exc):
        fc.check_verify_inputs(**tensors, **dict(kw, **kw_edit))


def test_verify_records_build_entry(tmp_path, monkeypatch):
    """``verify_records`` is built like the other kernels, and its source
    enters no other kernel's library digest."""
    assert "verify_records" in _build.KERNELS
    with_it = {n: _build.library_path(n).name for n in _build.KERNELS}
    assert with_it["verify_records"].startswith("libverify_records-")
    bare = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, bare)
    (bare / "verify_records.cu").unlink()
    monkeypatch.setattr(_build, "CSRC", bare)
    others = [n for n in _build.KERNELS if n != "verify_records"]
    assert len(others) == 7
    assert {n: _build.library_path(n).name for n in others} == {
        n: with_it[n] for n in others}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("step,dtype", TABLES)
@pytest.mark.parametrize("B,L,capacity", SHAPES)
def test_verify_records_kernel_matches_plain(cuda, B, L, capacity, step,
                                             dtype, grid):
    """The kernel's ``(rec_cell, rec_pack, n_rec)`` bit for bit against the
    plain version on the same CUDA tensors, one launch a call; against the
    JAX package too where it is installed (the CPU tests above hold the
    plain version against it on these cases)."""
    args, kw = _inputs(B, L, capacity, step, dtype, grid)
    before = fc.verify_records.launches
    got = _port(args, kw, step, cuda)
    want = ft._verify_records_torch(*_torch_args(args, cuda), **kw,
                                    step=step)
    torch.cuda.synchronize()
    assert fc.verify_records.launches == before + 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == torch.int32 and a.shape == b.shape
        assert torch.equal(a, b)
    _check_shape(got, capacity, grid)
    if importlib.util.find_spec("jax") is not None:
        _assert_records(got, _jax(args, kw, step))


@pytest.mark.cuda
@pytest.mark.parametrize("step,dtype", TABLES)
def test_verify_records_kernel_wide_alphabet(cuda, step, dtype):
    """The kernel against the plain version where the plain version takes
    its classes from the ``byte_class`` gather (more than 32 used bytes)."""
    args, kw = _inputs(16, 256, 4096, step, dtype, "drawn", WIDE)
    got = _port(args, kw, step, cuda)
    want = ft._verify_records_torch(*_torch_args(args, cuda), **kw,
                                    step=step)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(got[2]) > 0
