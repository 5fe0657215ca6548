"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on CUDA unless the caller asks for the CPU."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "php_aho_corasick_tpu_torch"

_PROBE = r"""
import sys
sys.modules["jax"] = None
sys.modules["php_aho_corasick_tpu"] = None
import torch
# one intra-op thread: the probe's many small ops then keep their speed
# when the other test workers load every core
torch.set_num_threads(1)
import php_aho_corasick_tpu_torch as port

pats = [b"abcdefabcdef", b"cdefabcdefab", b"xy"]
m = port.Matcher([{"value": p} for p in pats],
                 port.ScanConfig(engine="cascade", chunk_len=256),
                 device="cpu")
doc = b"ab" * 300 + pats[0] + b"c" * 50 + b"xy" + b"d" * 400
res = m.match_arrays_many([m.device_corpus([doc, doc[::-1]])])[0]
got = sorted(zip(res["doc"].tolist(), res["pos"].tolist(),
                 res["pattern"].tolist()))
want = [(0, 612, 0), (0, 664, 2)]
assert got == want, got
# the stream (device carry, then the cascade's prefix path), iter_matches,
# replace, the cross-batch double buffer and the fresh-corpus pipeline
for cfg in (dict(), dict(engine="cascade")):
    ms = port.Matcher([{"value": p} for p in pats],
                      port.ScanConfig(backend="device", chunk_len=256, **cfg),
                      device="cpu")
    with ms.stream() as st:  # the first needle spans the two feeds
        recs = st.feed(doc[:610]) + st.feed(doc[610:])
    assert [(r["pos"], r["value"]) for r in recs] == [
        (612, pats[0]), (664, b"xy")], recs
    assert list(ms.iter_matches(doc, segment_bytes=610)) == recs
    out = ms.replace(doc, {b"xy": b"Z"})
    rs = ms.replace_stream({b"xy": b"Z"}, mode="lazy")
    assert rs.feed(doc[:650]) + rs.feed(doc[650:]) + rs.flush() == out
    assert out == doc.replace(b"xy", b"Z")
ms = port.Matcher([{"value": p} for p in pats],
                  port.ScanConfig(engine="cascade", chunk_len=256,
                                  fresh_slice_bytes=2048), device="cpu")
hs = ms.device_corpus([doc, doc[::-1]])
assert len(list(ms.match_arrays_stream([[hs], [hs, hs]]))) == 2
res = ms.match_arrays([doc, doc[::-1]] * 3)
assert ms.stats.last_engine == "cascade-fresh", ms.stats.last_engine
assert res["pos"].tolist() == [612, 664] * 3, res
# the PHP-parity surface through the tile engine
t = port.ahocorasick_init([{"key": "ab", "value": "alfa"}, {"value": "lfa"}],
                          device="cpu")
t.config = port.ScanConfig(backend="device")
recs = port.ahocorasick_match("alFABETA gamma zetaomegaalfa!", t)
assert t.stats.last_engine == "tile", t.stats.last_engine
assert [(r["pos"], r["value"]) for r in recs] == [(28, "alfa"), (28, "lfa")]
# the per-row sampled filter (stride 5) and the anchored cascade
import numpy as np
rng = np.random.default_rng(5)
abc = np.frombuffer(b"abcdef", np.uint8)
for n, length, mode, stride in ((2048, 13, "sampled", 5),
                                (2048, 7, "anchored", 0)):
    pats = sorted({rng.choice(abc, length).tobytes() for _ in range(n)})
    m = port.Matcher([{"value": p} for p in pats],
                     port.ScanConfig(engine="cascade", chunk_len=512),
                     device="cpu")
    assert (m.cascade_model.plan.mode, m.cascade_model.plan.stride) == (
        mode, stride), m.cascade_model.plan.reason
    doc = rng.choice(abc, 3000).tobytes() + pats[9] + b"xyz" * 10
    res = m.match_arrays([doc])
    assert (3000 + length, 9) in zip(res["pos"].tolist(),
                                     res["pattern"].tolist()), res
# the take filters: asked for, and the flat one after > 128 survivors in
# one extraction group
pats = [b"abcdefabcdef", b"cdefabcdefab", b"xy"]
m = port.Matcher([{"value": p} for p in pats],
                 port.ScanConfig(engine="cascade", chunk_len=256,
                                 bloom_impl="take"), device="cpu")
assert m.cascade_model.bloom_impl() == "take"
doc = b"ab" * 300 + pats[0] + b"c" * 50 + b"xy" + b"d" * 400
res = m.match_arrays_many([m.device_corpus([doc, doc[::-1]])])[0]
assert sorted(zip(res["doc"].tolist(), res["pos"].tolist(),
                  res["pattern"].tolist())) == want
# the grouped take filter's two kernel wrappers (plain versions here),
# through the Matcher above and called directly
from php_aho_corasick_tpu_torch.ops import filter_cuda, filter_torch
chunks = torch.from_numpy(rng.integers(97, 100, (3, 512)).astype(np.uint8))
wc = filter_torch.pack_corpus_words(chunks)
words = torch.full((1 << 10,), 1 << 7, dtype=torch.int32)
r_s, w_s, swo_s, c_s, cnt = filter_cuda.grouped_take_extract(
    words, wc, None, torch.tensor(1, dtype=torch.int32), q=9, spc=2,
    log2_words=10, salts=(5, 7), mpr=8, block_r=128)
assert int(cnt.sum()) == 3 * 64 and int(cnt.max()) == 2
slot, n = filter_torch.blocked_nonzero((r_s >= 0).reshape(-1), 256)
idx, lw, swo = filter_cuda.grouped_take_refine(
    slot, r_s, w_s, swo_s, wc, torch.zeros(1 << 10, dtype=torch.int32),
    mpr=8, block_r=128, spc=2, prefix_salts=(3,), prefix_log2=15,
    prefix_len=12)
assert int(n) == 192 and bool((idx == filter_torch.INT32_MAX).all())
p = b"abcdefabcdefabcd"
m = port.Matcher([{"value": p}],
                 port.ScanConfig(engine="cascade", cascade_mode="sampled",
                                 bloom_impl="pallas_vmem", chunk_len=4096),
                 device="cpu")
recs = m.match(p * 70000)
assert m.cascade_model._force_take and len(recs) == 70000
# the compressed table (finalize's switch, the compressed dfa and the
# cascade's compressed records walk), the k-gram engine, and the
# flagged-window verify with the records gate shut
from php_aho_corasick_tpu_torch.models.cascade import CascadeModel
from php_aho_corasick_tpu_torch.models.compressed_dfa import CompressedDfaModel
from php_aho_corasick_tpu_torch.models.kgram_dfa import KgramDfaModel
pats = sorted({rng.choice(abc, 16).tobytes() for _ in range(40)})
doc = rng.choice(abc, 5000).tobytes() + pats[3] + b"xyz" + pats[5]
want = [(5016, 3), (5035, 5)]
for cfg in (dict(dense_table_max_bytes=64, cascade_min_bytes=1024),
            dict(dense_table_max_bytes=64, engine="cascade",
                 bloom_impl="take"),
            dict(table_format="compressed", engine="dfa")):
    m = port.Matcher([{"value": p} for p in pats],
                     port.ScanConfig(chunk_len=512, **cfg), device="cpu")
    assert m.table_format == "compressed"
    assert isinstance(m.model, CompressedDfaModel)
    res = m.match_arrays_many([m.device_corpus([doc])])[0]
    assert list(zip(res["pos"].tolist(), res["pattern"].tolist())) == want
m = port.Matcher([{"value": p} for p in pats],
                 port.ScanConfig(engine="kgram", chunk_len=512),
                 device="cpu")
res = m.match_arrays([doc])
assert isinstance(m.kgram_model, KgramDfaModel) and m.kgram_model.k >= 2
assert list(zip(res["pos"].tolist(), res["pattern"].tolist())) == want
# the data mesh: a sharded handle on 4 shards of the CPU, the dry run,
# and the two-process worker's module
import importlib.util
from php_aho_corasick_tpu_torch.parallel import dryrun, mesh, shard_scan
pats_s = [b"abcdefabcdef", b"cdefabcdefab", b"xy"]
ms = port.Matcher([{"value": p} for p in pats_s],
                  port.ScanConfig(engine="cascade", chunk_len=256),
                  device="cpu")
doc_s = b"ab" * 300 + pats_s[0] + b"c" * 50 + b"xy" + b"d" * 400
with mesh.local_shards(4):
    hs = ms.device_corpus([doc_s, doc_s[::-1]], shard=True)
    res = ms.match_arrays_many([hs])[0]
    assert len(hs.mesh) == 4 and len(hs.chunks_d) == 4
    assert sorted(zip(res["doc"].tolist(), res["pos"].tolist(),
                      res["pattern"].tolist())) == [(0, 612, 0), (0, 664, 2)]
dryrun.dryrun_multichip(2, "cpu")
spec = importlib.util.spec_from_file_location(
    "torch_distributed_worker", "tests/test_torch_distributed.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
# the remaining surface: the native builder and oracle, save and load,
# the profiling hooks, the command line and the examples
import contextlib, io, tempfile
from php_aho_corasick_tpu_torch import native
from php_aho_corasick_tpu_torch.__main__ import main as cli
from php_aho_corasick_tpu_torch.examples import basic, bulk_scan, serving_loop
from php_aho_corasick_tpu_torch.utils import profiling, serialization
mn = port.Matcher([{"value": p} for p in pats_s], device="cpu")
assert isinstance(mn._trie, native.NativeTrieBuilder)
assert "/build/torch_kernels/libaho_native-" in native.loaded_path()
assert [r["pos"] for r in mn.match(doc_s)] == [612, 664]  # oracle_scan
buf = io.StringIO()
with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(buf):
    serialization.save_matcher(mn, tmp + "/m.npz")
    ml = serialization.load_matcher(tmp + "/m.npz", device="cpu")
    assert ml.match(doc_s) == mn.match(doc_s)
    with open(tmp + "/p.txt", "wb") as f:
        f.write(b"\n".join(pats_s))
    with open(tmp + "/c.bin", "wb") as f:
        f.write(doc_s)
    assert cli(["scan", "-p", tmp + "/p.txt", "-i", tmp + "/c.bin",
                "--device", "cpu"]) == 0
    with profiling.trace(tmp):
        profiling.sync(torch.ones(3))
    basic.main(device="cpu")
    bulk_scan.main(device="cpu", n_needles=16, doc_bytes=2048, n_docs=2,
                   n_batches=1)
    serving_loop.main(device="cpu", n_signatures=64, doc_bytes=512,
                      n_docs=4)
assert '"pos": 612' in buf.getvalue(), buf.getvalue()
CascadeModel.records_ok = property(lambda self: False)
for cfg in (dict(), dict(verify_kgram_bytes=0),
            dict(table_format="compressed")):
    m = port.Matcher([{"value": p} for p in pats],
                     port.ScanConfig(engine="cascade", chunk_len=512, **cfg),
                     device="cpu")
    res = m.match_arrays([doc])
    assert list(zip(res["pos"].tolist(), res["pattern"].tolist())) == want
# one case of the randomized soak (a sharded dfa scan) against brute force
from php_aho_corasick_tpu_torch import soak
case = soak.draw_case(827307999)
assert case["shards"] == 2 and case["config"]["engine"] == "dfa"
assert "ok" in soak.run_case(case, "cpu")
# the measurement tools at tiny sizes
from php_aho_corasick_tpu_torch.bench import (
    headline, reference_protocol, scaling, signatures, stage_budget)
with contextlib.redirect_stdout(io.StringIO()):
    assert headline.run(mib=1, reps=1, device="cpu")["detail"]["matches"] == 0
    assert signatures.run("hex", 300, 16, 1, device="cpu")["matches"] >= 190
    assert stage_budget.run(mib=1, reps=1, device="cpu")["ms"]["public"] > 0
    assert scaling.run(2, 1, "cascade", device="cpu")["count"] > 0
    assert reference_protocol.run(
        samples=1, needles=32, needle_len=4, haystacks=4, haystack_len=1024,
        naive_needles=4, device="cpu")["matches"] > 0
loaded = [n for n in sys.modules
          if n == "jax" or n.startswith("jax.")
          or n == "php_aho_corasick_tpu" or n.startswith("php_aho_corasick_tpu.")]
assert not [n for n in loaded if sys.modules[n] is not None], loaded
print("ok")
"""


def test_port_runs_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_no_jax_imports_in_sources():
    pattern = re.compile(
        r"^\s*(import\s+jax\b|from\s+jax\b|import\s+php_aho_corasick_tpu\b(?!_)"
        r"|from\s+php_aho_corasick_tpu\b(?!_))",
        re.M,
    )
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        src = f.read_text()
        assert not pattern.search(src), f
        assert not re.search(r"php_aho_corasick_tpu\.\w", src), f


def test_default_device_needs_cuda(monkeypatch):
    import php_aho_corasick_tpu_torch as port

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.Matcher()
    with pytest.raises(RuntimeError):
        port.Matcher(device="cuda")
    assert port.Matcher(device="cpu").device.type == "cpu"


def test_sharded_cuda_needs_card(monkeypatch):
    """A sharded entry point on CUDA raises with no card; it never carries
    on on the CPU."""
    from php_aho_corasick_tpu_torch.parallel import dryrun, mesh, shard_scan

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.data_mesh()
    with mesh.local_shards(2):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.data_mesh(device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.DataMesh([torch.device("cuda", 0)] * 2)
    with pytest.raises(RuntimeError):
        dryrun.dryrun_multichip(2, "cuda")
    rows = np.zeros((4, 8), np.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shard_scan.sharded_scan_compact(
            mesh.DataMesh(["cuda:0", "cuda:0"]), {}, rows, None,
            np.zeros(4, np.int32), np.zeros(4, np.int32), n_classes=1,
            capacity=4,
        )
