"""The port's flagged-window device verify against the JAX package's.

Sampled plans whose windows fit 32 bytes but not the records gate (a
window of exactly 32 bytes, or 2^26 states and more) verify on the device
by flagging the windows that hold a match
(``CascadeModel.launch_device``), and the host re-walks those windows
(``emit_windows_arrays``).  The three verifiers split by table: the
per-class dense walk, its k-gram super-steps (``verify_kv`` 2-4) and the
compressed walk.  Every array compared is an integer array, compared
exactly.
"""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import php_aho_corasick_tpu as ref  # noqa: E402
from php_aho_corasick_tpu.models import cascade as ref_cascade  # noqa: E402
from php_aho_corasick_tpu.models import kgram_dfa as ref_kgram  # noqa: E402
from php_aho_corasick_tpu.ops import filter_jax  # noqa: E402
from php_aho_corasick_tpu.ops.matches import (  # noqa: E402
    pack_documents as ref_pack,
)

import php_aho_corasick_tpu_torch as port  # noqa: E402
from php_aho_corasick_tpu_torch import carry  # noqa: E402
from php_aho_corasick_tpu_torch.models import cascade as port_cascade  # noqa: E402
from php_aho_corasick_tpu_torch.ops import filter_torch  # noqa: E402
from php_aho_corasick_tpu_torch.ops.matches import pack_documents  # noqa: E402
from test_torch_compressed import _fields  # noqa: E402
from test_torch_slice import _assert_same  # noqa: E402

INT32_MAX = 2**31 - 1


def _brute(patterns, text):
    out = []
    for pid, p in enumerate(patterns):
        start = text.find(p)
        while start != -1:
            out.append((start + len(p), -len(p), pid))
            start = text.find(p, start + 1)
    out.sort()
    return [(pos, pid) for pos, _, pid in out]


def _planted(seed, n_pats=32, length=16, n_bytes=8000, n_plant=10):
    rng = random.Random(seed)
    patterns = sorted({bytes(rng.choice(b"abcdef") for _ in range(length))
                       for _ in range(n_pats)})
    text = bytearray(rng.choice(b"abcdef") for _ in range(n_bytes))
    for _ in range(n_plant):
        p = rng.choice(patterns)
        pos = rng.randrange(0, len(text) - len(p))
        text[pos : pos + len(p)] = p
    return patterns, bytes(text)


def _window_case(table_format):
    """A reference-built automaton (and the port's copy), a packed corpus
    with planted needles, and a hit list: every planted needle's grid
    cell, random cells and pads."""
    patterns, text = _planted(11, n_bytes=3000, n_plant=40)
    m = ref.Matcher([{"value": p} for p in patterns],
                    ref.ScanConfig(table_format=table_format))
    auto_j = m.automaton
    from_arrays = (carry.compressed_automaton_from_arrays
                   if table_format == "compressed"
                   else carry.automaton_from_arrays)
    auto_t = from_arrays(_fields(auto_j))
    stride = 8
    packed = pack_documents([text, text[::-1]], 1024, auto_j.max_len - 1)
    B, L = packed.chunks.shape
    M = -(-L // stride)
    rng = np.random.default_rng(5)
    cells = set(rng.choice(B * M, 60, replace=False).tolist())
    for p in patterns:  # the cells owning the starts in row 0
        at = text.find(p)
        while 0 <= at < 1024 - len(p):
            cells.add(-(-at // stride))
            at = text.find(p, at + 1)
    grid = np.full(128, INT32_MAX, np.int32)
    cells = np.array(sorted(c for c in cells if c < B * M), np.int32)
    grid[: cells.shape[0]] = cells
    win_len = stride - 1 + auto_j.max_len
    return auto_j, auto_t, packed, grid, stride, win_len


def _same(want, got):
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("capacity", [64, 3])
def test_verify_windows_matches_jax(capacity):
    """The per-class dense walk: ``(win_cell, n_flagged)`` bit for bit,
    also when the flagged windows overflow the capacity."""
    auto_j, auto_t, packed, grid, stride, W = _window_case("dense")
    kw = dict(n_classes=auto_j.n_classes, stride=stride, win_len=W,
              capacity=capacity, n_hits=grid.shape[0])

    def args(auto, conv):
        return [conv(x) for x in (
            np.ascontiguousarray(auto.table).reshape(-1),
            auto.byte_class.astype(np.int32), auto.used_bytes,
            packed.chunks, packed.lengths, grid, np.int32(auto.final_start))]

    want = filter_jax.verify_windows(*args(auto_j, jnp.asarray), **kw)
    got = filter_torch.verify_windows(*args(auto_t, torch.as_tensor), **kw)
    _same(want, got)
    assert int(got[1]) > 3


@pytest.mark.parametrize("kv,int16", [(2, True), (3, False)])
def test_verify_windows_kgram_matches_jax(kv, int16):
    """The k-gram super-step walk (``kv`` 2 on an int16 table, 3 on an
    int32 one) flags the same windows as the JAX package, and as the
    per-class walk."""
    auto_j, auto_t, packed, grid, stride, W = _window_case("dense")
    cfg = ref.ScanConfig(allow_int16_states=int16,
                         prefer_native_builder=False)
    ktable = ref_kgram.KgramDfaModel(auto_j, cfg, k=kv).ktable_host
    assert ktable.dtype == (np.int16 if int16 else np.int32)
    kw = dict(n_classes=auto_j.n_classes, stride=stride, win_len=W,
              capacity=64, n_hits=grid.shape[0])

    def args(auto, conv, table):
        return [conv(x) for x in (
            table, auto.byte_class.astype(np.int32), auto.used_bytes,
            packed.chunks, packed.lengths, grid, np.int32(auto.final_start))]

    want = filter_jax.verify_windows_kgram(
        *args(auto_j, jnp.asarray, ktable), kv=kv, **kw)
    got = filter_torch.verify_windows_kgram(
        *args(auto_t, torch.as_tensor, ktable), kv=kv, **kw)
    _same(want, got)
    plain = filter_torch.verify_windows(*args(
        auto_t, torch.as_tensor,
        np.ascontiguousarray(auto_t.table).reshape(-1)), **kw)
    for a, b in zip(plain, got):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert int(got[1]) > 0


def test_verify_windows_compressed_matches_jax():
    auto_j, auto_t, packed, grid, stride, W = _window_case("compressed")
    kw = dict(n_classes=auto_j.n_classes, n_dense=auto_j.n_dense,
              stride=stride, win_len=W, capacity=64, n_hits=grid.shape[0])

    def args(auto, conv):
        meta = auto.meta if auto.meta.size else np.zeros(1, np.int32)
        tgt = auto.exc_target if auto.exc_target.size else np.zeros(
            1, np.int32)
        return [conv(x) for x in (
            auto.dense_table.reshape(-1), meta, tgt,
            auto.byte_class.astype(np.int32), auto.used_bytes,
            packed.chunks, packed.lengths, grid,
            np.int32(auto.dense_final_start), np.int32(auto.final_start))]

    want = filter_jax.verify_windows_compressed(*args(auto_j, jnp.asarray),
                                                **kw)
    got = filter_torch.verify_windows_compressed(
        *args(auto_t, torch.as_tensor), **kw)
    _same(want, got)
    assert int(got[1]) > 0


#: the verifier ``launch_device`` takes: the per-class dense walk (no
#: room for a k-gram table), the k-gram walk, the compressed walk
VERIFIERS = {
    "dense": dict(verify_kgram_bytes=0),
    "kgram": dict(),
    "compressed": dict(table_format="compressed"),
}


@pytest.mark.parametrize("kind", sorted(VERIFIERS))
def test_launch_device_emit_windows_matches_jax(kind):
    """Several filter -> flagged-window chains in flight with one fetch
    of their counts, as the JAX package's own test runs them (both on the
    take filter): the cells and counts equal, and ``emit_windows`` yields
    the brute-force matches."""
    patterns, text = _planted(7)
    base = dict(backend="device", engine="cascade", auto_shard=False,
                cascade_mode="sampled", chunk_len=512, bloom_impl="take",
                **VERIFIERS[kind])
    specs = [{"id": i, "value": p} for i, p in enumerate(patterns)]
    mj = ref.Matcher(specs, ref.ScanConfig(**base))
    mt = port.Matcher(specs, port.ScanConfig(**base), device="cpu")
    cj, ct = mj.cascade_model, mt.cascade_model
    assert ct.device_verify_ok and ct.verify_kv == cj.verify_kv
    assert ct._compressed == (kind == "compressed")
    assert (ct.verify_kv > 1) == (kind == "kgram")
    packed = ref_pack([text], 512, mj.automaton.max_len - 1)
    cap_a, cap_b = 4096, 1024
    want = cj.launch_device(jnp.asarray(packed.chunks),
                            jnp.asarray(packed.lengths), cap_a, cap_b)
    chunks, lengths = (torch.from_numpy(x)
                       for x in (packed.chunks, packed.lengths))
    outs = [ct.launch_device(chunks, lengths, cap_a, cap_b)
            for _ in range(3)]
    counts = torch.stack([s for _c, n, nf, nc in outs for s in (n, nf)])
    ns, nfs = counts[0::2].tolist(), counts[1::2].tolist()
    assert len(set(ns)) == len(set(nfs)) == 1
    assert 0 < ns[0] <= cap_a and 0 < nfs[0] <= cap_b
    _same(want, outs[-1])
    got = [(end, int(pids[0])) for _doc, end, pids in ct.emit_windows(
        packed, outs[-1][0].numpy(), nfs[0])]
    assert got == _brute(patterns, text)
    want_e = cj.emit_windows_arrays(packed, np.asarray(want[0]), nfs[0])
    got_e = ct.emit_windows_arrays(packed, outs[-1][0].numpy(), nfs[0])
    for a, b in zip(want_e, got_e):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["dense", "compressed", "take"])
def test_run_arrays_flagged_branch_matches_jax(kind, monkeypatch):
    """With the records gate shut (``records_ok`` False on both packages'
    ``CascadeModel``), ``run_arrays`` takes the flagged-window branch:
    records equal the JAX Matcher's, dict for dict and array for array,
    through a capacity retry of the verify stage; ``run`` and ``verify``
    iterate what ``run_arrays`` and ``verify_arrays`` return."""
    for cls in (ref_cascade.CascadeModel, port_cascade.CascadeModel):
        monkeypatch.setattr(cls, "records_ok", property(lambda self: False))
    patterns, text = _planted(21, n_plant=40)
    docs = [text, text[::-1], text[:3000] + patterns[0] * 3]
    extra = {"dense": {}, "compressed": dict(table_format="compressed"),
             "take": dict(bloom_impl="take")}[kind]
    cfg = dict(backend="device", engine="cascade", auto_shard=False,
               cascade_mode="sampled", chunk_len=512, **extra)
    specs = [{"id": i, "value": p} for i, p in enumerate(patterns)]
    mj = ref.Matcher(specs, ref.ScanConfig(**cfg))
    mt = port.Matcher(specs, port.ScanConfig(**cfg), device="cpu")
    ct = mt.cascade_model
    assert not ct.records_ok and ct.device_verify_ok
    ct._cap_flagged = 4  # the verify stage overflows once
    want = mj.match_many(docs)
    assert mt.match_many(docs) == want
    assert ct._cap_flagged > 4 and mt.stats.capacity_retries >= 1
    _assert_same(mj.match_arrays(docs), mt.match_arrays(docs))
    h = mt.device_corpus(docs)
    _assert_same(mj.match_arrays(docs), mt.match_arrays_many([h])[0])
    assert mt.stats.records_fallbacks >= 1
    got = list(ct.run(h.packed, 64, dev_inputs=h.dev_inputs_for(ct)))
    flat = [(d, e, int(p[0])) for d, e, p in got]
    arrs = mj.match_arrays(docs)
    assert flat == list(zip(arrs["doc"].tolist(), arrs["pos"].tolist(),
                            arrs["pattern"].tolist()))
    starts = np.array([text.find(p) for p in patterns
                       if 0 <= text.find(p) < 400], np.int64)  # in row 0
    va = ct.verify_arrays(h.packed, starts, starts.shape[0])
    assert [(d, e, int(p[0])) for d, e, p in ct.verify(
        h.packed, starts, starts.shape[0])] == list(
        zip(*(x.tolist() for x in va)))
    assert va[0].shape[0] >= 1
