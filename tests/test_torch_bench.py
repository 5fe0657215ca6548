"""The port's measurement tools (``php_aho_corasick_tpu_torch.bench``)
against the JAX package's ``bench.py`` and ``benchmarks/`` scripts: the
same draws (reproduced inline from the reference scripts), records with
the reference's keys, and matches equal to the JAX ``Matcher``'s on the
same cut workload, on ``device="cpu"``.  The JAX side scans on the host
backend (its exact native scan), which the reference's ``Matcher`` serves
record-equal to its device engines."""

import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import php_aho_corasick_tpu as ref  # noqa: E402

from php_aho_corasick_tpu_torch.bench import (  # noqa: E402
    headline, reference_protocol, scaling, signatures, stage_budget,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the reference records' keys (``BENCH_TPU_LAST.json``,
#: ``benchmarks/signature_last.json``, ``stage_budget_last.json``; the
#: scaling and protocol scripts print theirs), and what the port adds
HEADLINE_KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}
DETAIL_KEYS = {
    "corpus_mib", "pass_ms", "pass_ms_spread", "public_api",
    "caps_moved_during_timing", "e2e_gbps_via_relay", "cold_path",
    "build_s", "engine", "states", "matches", "match_density_gbps",
    "signature_scale", "device",
}
COLD_KEYS = {"pack_gbps", "upload_gbps", "cold_scan_gbps", "engine"}
DENSITY_KEYS = {"gbps", "gbps_spread", "pass_ms", "matches", "corpus_mib",
                "cold_capacity_retries"}
SIGNATURE_KEYS = {
    "alphabet", "needles", "needle_len", "states", "table_mib",
    "table_format", "build_s", "corpus_mib", "gbps", "pass_ms", "matches",
    "planted", "dfa_fallback_gbps", "engine", "measured_at",
}
STAGE_KEYS = {"ms", "cap_a", "cap_r", "mpr", "at"}
STAGE_ROWS = {"prep", "fused", "filter", "filterP", "records", "public"}
SCALING_KEYS = {"engine", "mib", "rows"}
PROTOCOL_KEYS = {"samples", "corpus_mib", "avg_naive_s", "avg_ac_s",
                 "ac_gibps", "speedup", "reference"}
PORT_KEYS = {"device", "kernels"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU cascade is many small torch ops; one intra-op thread
    keeps their speed when other test workers load every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_arrays(patterns, docs):
    m = ref.Matcher([{"id": i, "value": p} for i, p in enumerate(patterns)],
                    ref.ScanConfig(backend="host", chunk_len=4096))
    return m.match_arrays(docs)


# ---------------------------------------------------------------- draws


@pytest.fixture(scope="module")
def headline_draws():
    """``bench.py:91-102``, inline."""
    rng = random.Random(1337)
    alphabet = b"abcdef"
    needles = set()
    while len(needles) < 2048:
        needles.add(bytes(rng.choice(alphabet) for _ in range(16)))
    needles = sorted(needles)
    base_docs = [
        bytes(rng.choice(alphabet) for _ in range(8192)) for _ in range(256)
    ]
    return needles, base_docs


def test_headline_draws_equal_reference(headline_draws):
    needles, base_docs = headline_draws
    assert headline.draws() == (needles, base_docs)
    assert headline.corpus(base_docs, 128 << 20) == base_docs * 64
    assert headline.corpus(base_docs, 64 << 20) == base_docs * 32
    # the density plants (bench.py:217-227) over a cut corpus
    for dens in (1e-5, 1e-3):
        n_plant = int(dens * sum(map(len, base_docs)))
        prng = random.Random(int(dens * 1e9))
        want = [bytearray(d) for d in base_docs]
        for _ in range(n_plant):
            di = prng.randrange(len(want))
            off = prng.randrange(8192 - 16)
            nd = needles[prng.randrange(len(needles))]
            want[di][off : off + 16] = nd
        got, plants = headline.planted(base_docs, needles, dens)
        assert len(plants) == n_plant and got == [bytes(d) for d in want]


_SIG_REF = r"""
import numpy as np
from php_aho_corasick_tpu_torch.bench import signatures

def reference(alphabet, needles, needle_len, mib):
    # bench_signatures.py:49-79, inline
    rng = np.random.default_rng(7)
    if alphabet == "hex":
        amap = np.frombuffer(b"0123456789abcdef", np.uint8)
        draw = lambda n: amap[rng.integers(0, 16, n, dtype=np.uint8)]
    else:
        draw = lambda n: rng.integers(0, 256, n, dtype=np.uint8)
    raw = draw((needles, needle_len))
    patterns = list({bytes(raw[i]) for i in range(needles)})
    n_bytes = mib * 2**20
    corpus = bytearray(draw(n_bytes))
    planted = 0
    doc_sz = 2**20
    for j in range(0, n_bytes - 16, max(n_bytes // 200, 1)):
        if j % doc_sz > doc_sz - needle_len:
            continue
        corpus[j : j + needle_len] = patterns[j % len(patterns)]
        planted += 1
    docs = [bytes(corpus[i : i + doc_sz]) for i in range(0, n_bytes, doc_sz)]
    return patterns, docs, planted

for alphabet in ("hex", "byte"):
    want = reference(alphabet, 2000, 16, 2)
    got = signatures.draws(alphabet, 2000, 16, 2)
    assert set(got[0]) == set(want[0]) and len(got[0]) == len(want[0])
    assert got[2] == want[2] > 190
    assert got[1] == want[1], alphabet
print("ok")
"""


def test_signature_draws_equal_reference():
    """The needle sets as sets; the plants (which follow the list's order,
    so ``PYTHONHASHSEED``) with the hash seed fixed in both."""
    env = dict(os.environ, PYTHONHASHSEED="0")
    out = subprocess.run([sys.executable, "-c", _SIG_REF], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_scaling_draws_equal_reference():
    """``bench_scaling.py:54-72``, inline, at 2 MiB."""
    rng = np.random.default_rng(5)
    alphabet = np.frombuffer(b"abcdef", np.uint8)
    pats = list({
        bytes(alphabet[rng.integers(0, 6, 16)]) for _ in range(2048)
    })
    n_bytes = 2 * 2**20
    corpus = bytes(alphabet[rng.integers(0, 6, n_bytes)])
    docs = [corpus[i : i + 2**20] for i in range(0, n_bytes, 2**20)]
    got_pats, got_docs = scaling.draws(2)
    assert set(got_pats) == set(pats) and len(got_pats) == len(pats)
    assert got_docs == docs


def test_protocol_draws_equal_reference():
    """``benchmark_reference.py``'s ``gen`` and its sample loop, inline."""
    def gen(rng, n, alphabet=b"abcdef"):
        return bytes(rng.choice(alphabet) for _ in range(n))

    rng = random.Random(20260817)
    want = []
    for _ in range(2):
        needles = list({gen(rng, 16) for _ in range(64)})
        haystacks = [gen(rng, 512) for _ in range(4)]
        want.append((needles, haystacks))
    rng = random.Random(20260817)
    for w_needles, w_hays in want:
        needles, hays = reference_protocol.draw_sample(rng, 64, 16, 4, 512)
        assert set(needles) == set(w_needles) and hays == w_hays


# ---------------------------------------------------------------- records


def test_headline_record(headline_draws):
    """At 1 MiB: the headline pass on the cascade, the density rows on
    512 KiB (below ``cascade_min_bytes``: the engine the matcher picks)."""
    rec = headline.run(mib=1, reps=1, device="cpu")
    assert set(rec) == HEADLINE_KEYS | {"kernels"}
    d = rec["detail"]
    assert set(d) == DETAIL_KEYS | {"e2e_path"}
    assert set(d["cold_path"]) == COLD_KEYS
    assert set(d["match_density_gbps"]) == {"1e-05", "0.001"}
    assert d["device"] == "cpu" and d["signature_scale"] is None
    assert d["engine"].startswith("cascade/sampled q=9 stride=8")
    assert d["corpus_mib"] == 1.0 and len(d["pass_ms_spread"]) == 5
    assert set(rec["kernels"]) == {"fused_sampled_extract", "bloom_word_vmem",
                                   "bloom_hit", "scan_states_tile",
                                   "grouped_take_extract",
                                   "grouped_take_refine", "verify_records",
                                   "flat_take_extract"}
    needles, base_docs = headline_draws
    docs = headline.corpus(base_docs, 1 << 20)
    assert d["matches"] == _jax_arrays(needles, docs)["doc"].shape[0] == 0
    dens_docs = headline.corpus(base_docs, 1 << 19)
    for dens in (1e-5, 1e-3):
        row = d["match_density_gbps"][f"{dens:g}"]
        assert set(row) == DENSITY_KEYS
        pdocs, plants = headline.planted(dens_docs, needles, dens)
        want = _jax_arrays(needles, pdocs)["doc"].shape[0]
        assert row["matches"] == want >= headline.surviving(pdocs, plants) > 0


@pytest.mark.parametrize("alphabet", ["hex", "byte"])
def test_signature_record(alphabet):
    rec = signatures.run(alphabet, 2000, 16, 1, device="cpu")
    assert set(rec) == SIGNATURE_KEYS | {"plan_s", "hash_seed"} | PORT_KEYS
    assert rec["alphabet"] == alphabet and rec["needles"] == 2000
    assert rec["engine"].startswith("sampled")
    patterns, docs, planted = signatures.draws(alphabet, 2000, 16, 1)
    assert rec["planted"] == planted
    want = _jax_arrays(patterns, docs)["doc"].shape[0]
    assert rec["matches"] == want >= planted


def test_stage_budget_record_and_records_row(headline_draws):
    rec = stage_budget.run(mib=1, reps=1, device="cpu")
    assert set(rec) == (STAGE_KEYS | {"spread", "launches", "busy"}
                        | PORT_KEYS)
    assert set(rec["ms"]) == set(rec["launches"]) == STAGE_ROWS
    assert all(lo <= rec["ms"][k] <= hi
               for k, (lo, hi) in rec["spread"].items())
    assert all(v > 0 for v in rec["ms"].values())
    assert rec["busy"] is None  # the profiler share is a card's number
    # the records row on a planted handle equals match_arrays on it, and
    # the JAX Matcher's arrays
    needles, base_docs = headline_draws
    pdocs, _plants = headline.planted(headline.corpus(base_docs, 1 << 20),
                                needles, 1e-3)
    import php_aho_corasick_tpu_torch as port

    m = port.Matcher([{"id": i, "value": p} for i, p in enumerate(needles)],
                     port.ScanConfig(backend="device", chunk_len=4096),
                     device="cpu")
    h = m.device_corpus(pdocs)
    want = m.match_arrays(h)
    calls = stage_budget.stages(m, h, reps=1)
    got = stage_budget.records_arrays(m, h, calls["records"]())
    jx = _jax_arrays(needles, pdocs)
    assert want["doc"].shape[0] > 1000
    for key in ("doc", "pos", "start_postion", "pattern"):
        np.testing.assert_array_equal(got[key], want[key])
        np.testing.assert_array_equal(got[key], jx[key])


@pytest.mark.parametrize("shorts", [(), (b"cab", b"fe")])
def test_fused_extract_args_are_the_chains(headline_draws, shorts,
                                           monkeypatch):
    """``CascadeModel.fused_extract_args`` (the stage budget's ``fused``
    row, ``chip_smoke.py``'s kernel checks) gives the fused kernel the
    arguments the records chain launches it with, short needles too."""
    import php_aho_corasick_tpu_torch as port
    from php_aho_corasick_tpu_torch.ops import filter_cuda

    needles, base_docs = headline_draws
    m = port.Matcher([{"id": i, "value": p}
                      for i, p in enumerate(list(needles) + list(shorts))],
                     port.ScanConfig(backend="device", chunk_len=4096),
                     device="cpu")
    h = m.device_corpus(headline.corpus(base_docs, 1 << 20))
    cm = m.cascade_model
    assert cm.plan.shorts == shorts and cm.bloom_impl() == "pallas_vmem"
    seen = []
    real = filter_cuda.fused_sampled_extract

    def spy(*args, **kw):
        seen.append((args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(filter_cuda, "fused_sampled_extract", spy)
    m.match_arrays(h)
    assert seen
    args, kw = cm.fused_extract_args(h.chunks_d, h.lengths_d,
                                     h.fused_phases(cm))
    got_args, got_kw = seen[-1]
    assert (args[2] is None) == (got_args[2] is None) == (not shorts)

    def same(a, b):
        if isinstance(a, torch.Tensor):
            return torch.equal(a, b)
        return a == b

    assert len(args) == len(got_args) == 4 and set(kw) == set(got_kw)
    assert all(same(a, b) for a, b in zip(args, got_args)
               if a is not None)
    assert all(same(kw[k], got_kw[k]) for k in kw), kw


@pytest.mark.parametrize("engine", ["dfa", "cascade"])
def test_scaling_record(engine):
    rec = scaling.run(devices=2, mib=2, engine=engine, device="cpu")
    assert set(rec) == (SCALING_KEYS | {"count", "shards_of_one_card",
                                        "hash_seed"} | PORT_KEYS)
    assert rec["shards_of_one_card"] is True
    assert [r["devices"] for r in rec["rows"]] == [1, 2]
    assert all(set(r) == {"devices", "gbps", "efficiency"}
               for r in rec["rows"])
    if engine == "dfa":  # the count is the matches over the shards
        pats, docs = scaling.draws(2)
        assert rec["count"] == _jax_arrays(pats, docs)["doc"].shape[0]


def test_protocol_record(tmp_path, capsys):
    """Cut to 4-symbol needles, so the samples hold matches."""
    art = tmp_path / "out" / "protocol.json"
    assert reference_protocol.main([
        "--device", "cpu", "--samples", "2", "--needles", "64",
        "--needle-len", "4", "--haystacks", "8", "--haystack-len", "2048",
        "--naive-needles", "8", "--artifact", str(art)]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert art.read_text().strip() == last  # the only file it writes
    assert os.listdir(tmp_path / "out") == ["protocol.json"]
    rec = json.loads(last)
    assert set(rec) == PROTOCOL_KEYS | {"matches", "hash_seed"} | PORT_KEYS
    rng = random.Random(20260817)
    want = []
    for _ in range(2):
        needles, hays = reference_protocol.draw_sample(rng, 64, 4, 8, 2048)
        want.append(sum(len(r) for r in ref.Matcher(
            [{"id": i, "value": p} for i, p in enumerate(needles)],
            ref.ScanConfig(backend="host")).match_many(hays)))
    assert [r["matches"] for r in rec["samples"]] == want
    assert rec["matches"] == sum(want) > 1000


TOOLS = {
    "headline": (headline, []),
    "signatures": (signatures, ["--needles", "100", "--mib", "1"]),
    "stage_budget": (stage_budget, []),
    "scaling": (scaling, ["--devices", "2", "--mib", "1"]),
    "reference_protocol": (reference_protocol, ["--samples", "1"]),
}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_needs_card_or_cpu(tool, monkeypatch):
    """With no card and no ``--device cpu`` a tool raises; it never falls
    back to the CPU."""
    mod, args = TOOLS[tool]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(args)
