"""The CRISPR guide library against a genome (``portbench/configs/
crispr-gecko2-grch38.json``): 20-mers over ACGT on the flat take filter,
the route the full library plans.  On ``device="cpu"`` the port's records
are held against the benchmark's plain reference
(``portbench/reference/matcher.py``: window hashes and an exact byte
compare, no JAX), over documents several rows long with needles planted
across the rows' halos and at the documents' ends; and the full
246,822-needle set is planned as the configuration states."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import php_aho_corasick_tpu_torch as port  # noqa: E402
from php_aho_corasick_tpu_torch.utils import profiling  # noqa: E402

from portbench import generator, spec  # noqa: E402
from portbench.reference.matcher import Needles, find  # noqa: E402

CONFIG = spec.config("crispr-gecko2-grch38")
CHUNK = CONFIG["scan_config"]["chunk_len"]
KEYS = (("doc", "doc"), ("pos", "pos"), ("start_postion", "start"),
        ("pattern", "pattern"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _needles(count, seed):
    spec_ = dict(CONFIG["needles"], count=count)
    return generator.needles(spec_, seed)


def _matcher(nd, **cfg):
    """A matcher of ``nd`` on the CPU.  At 4,096 needles the planner picks
    stride 8 (the grouped take filter); ``cascade_min_q=15`` makes it pick
    the full library's q=15, stride 6, which only the flat filter serves."""
    cfg = dict(CONFIG["scan_config"], bloom_impl="take", cascade_min_q=15,
               engine="cascade", **cfg)
    specs = [{"id": i, "value": r.tobytes()} for i, r in enumerate(nd)]
    return port.Matcher(specs, port.ScanConfig(**cfg), device="cpu")


def _handle_docs(rng, nd, lengths):
    """Documents of ``lengths`` bytes of ACGT, each with needles planted
    across every row boundary (``k * CHUNK``, inside the halo), at its
    first byte, at its last bytes, and at random offsets."""
    alpha = generator.alphabet(CONFIG["content"]["alphabet"])
    L = nd.shape[1]
    docs = []
    for n in lengths:
        d = generator.symbols(rng, alpha, (n,))
        starts = [0, n - L]
        starts += [k * CHUNK - L // 2 for k in range(1, n // CHUNK + 1)
                   if k * CHUNK + L // 2 <= n]
        starts += [k * CHUNK - L for k in range(1, n // CHUNK + 1)]
        starts += list(rng.integers(0, n - L + 1, 6))
        for s in starts:
            d[s : s + L] = nd[rng.integers(0, nd.shape[0])]
        docs.append(d)
    return docs


def _reference(docs, ref):
    D = max(len(d) for d in docs)
    arr = np.zeros((len(docs), D), np.uint8)
    for i, d in enumerate(docs):
        arr[i, : len(d)] = d
    return find(arr, ref, np.array([len(d) for d in docs], np.int64))


def _assert_records(got, want):
    assert got["pos"].size == want["pos"].size
    for k, r in KEYS:
        np.testing.assert_array_equal(got[k], want[r], err_msg=k)


def test_flat_take_records_equal_the_reference():
    rng = np.random.default_rng(2026)
    nd = _needles(4096, 2**33 + 11)
    m = _matcher(nd)
    cm = m.cascade_model
    assert (cm.plan.q, cm.plan.stride) == (CONFIG["expect"]["plan.q"],
                                          CONFIG["expect"]["plan.stride"])
    assert cm.bloom_impl() == "take" and cm.records_ok
    shapes = [[3 * CHUNK + 517, 9000], [CHUNK + 1, 5 * CHUNK], [14_003]]
    docs = [_handle_docs(rng, nd, s) for s in shapes]
    hs = [m.device_corpus([d.tobytes() for d in ds]) for ds in docs]
    assert cm.take_branch(hs[0].packed.row_len) == "flat"
    for h in hs:
        m.match_arrays(h)  # warm the capacities, as a server would
    with profiling.recording() as rec:
        got = m.match_arrays_many(hs)
    routes = {r.attrs["route"] for r in rec.records if r.name == "filter"}
    assert routes == {"flat"}
    assert m.stats.records_fallbacks == 0
    ref = Needles([r.tobytes() for r in nd])
    for g, ds in zip(got, docs):
        want = _reference(ds, ref)
        assert want["pos"].size >= sum(2 + len(d) // CHUNK for d in ds)
        _assert_records(g, want)
    # a handle alone (the adaptive chain of run_arrays) gives the same
    _assert_records(m.match_arrays(hs[1]), _reference(docs[1], ref))


def test_full_library_plans_the_configured_path():
    """The whole library, planned on the CPU (~7 s, ~2.5 GB: two 1 GiB
    positional blooms) by the benchmark's own ``Program``."""
    from portbench.system import Program

    nd = generator.needles(CONFIG["needles"], 2**33 + 5)
    assert nd.shape == (246_822, 20)
    traffic = spec.cell("gecko2-grch38-resident")["traffic_params"]
    prog = Program(CONFIG, traffic, 1, "cpu")
    try:
        prog.build(nd)
        assert prog.plan() == CONFIG["expect"]
        cm = prog.m.cascade_model
        assert cm.plan.vmem_words is None  # no bank bloom: the take route
        # a chromosome's rows: 4,096 bytes and a 19-byte halo, to 4,224
        assert cm.take_branch(4224) == "flat"
    finally:
        prog.close()
