"""The port's command line (``python -m php_aho_corasick_tpu_torch``) with
``--device cpu`` against the JAX package's, on ``tests/test_cli.py``'s
scenario: equal stdout lines, equal replaced bytes, saved automata that
each package's ``info`` reads; and the port's examples, run small on the
CPU."""

import contextlib
import io
import json
import runpy

import pytest

torch = pytest.importorskip("torch")

from php_aho_corasick_tpu.__main__ import main as ref_main  # noqa: E402

from php_aho_corasick_tpu_torch.__main__ import main  # noqa: E402
from php_aho_corasick_tpu_torch.examples import (  # noqa: E402
    basic,
    bulk_scan,
    serving_loop,
)

ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]


def _files(tmp_path):
    pats = tmp_path / "pats.txt"
    pats.write_bytes(b"alfa\ngamma\nlfa\n")
    corpus = tmp_path / "c.bin"
    corpus.write_bytes(b"xx alfa then gamma!" + b"ab lfa gammalfa " * 300)
    repl = tmp_path / "r.tsv"
    repl.write_bytes(b"alfa\tALPHA\ngamma\tGAMMA\n")
    return str(pats), str(corpus), str(repl)


@pytest.mark.parametrize("backend", ["host", "device", "auto"])
def test_cli_matches_jax_cli(tmp_path, capsys, backend):
    pats, corpus, repl = _files(tmp_path)
    out = {}
    for name, fn, extra in (("jax", ref_main, []),
                            ("port", main, ["--device", "cpu"])):
        common = ["--backend", backend] + extra
        assert fn(["scan", "-p", pats, "-i", corpus] + common) == 0
        scan = capsys.readouterr().out.splitlines()
        dst = tmp_path / f"{name}.out"
        assert fn(["replace", "-p", pats, "-r", repl, "-i", corpus,
                   "-o", str(dst)] + common) == 0
        auto = tmp_path / f"{name}.npz"
        assert fn(["build", "-p", pats, "-o", str(auto)] + common) == 0
        assert fn(["info", "-m", str(auto)] + extra) == 0
        out[name] = (scan, dst.read_bytes(), capsys.readouterr().out)
    assert out["port"] == out["jax"]
    scan, replaced, info = out["port"]
    assert [json.loads(x)["pos"] for x in scan[:3]] == [7, 7, 18]
    assert len(scan) == 3 + 300 * 4
    assert replaced.startswith(b"xx ALPHA then GAMMA!ab lfa GAMMAALPHA ")
    assert "13 states" in info
    # each package reads the other's saved automaton
    assert main(["info", "-m", str(tmp_path / "jax.npz"),
                 "--device", "cpu"]) == 0
    assert ref_main(["info", "-m", str(tmp_path / "port.npz")]) == 0
    both = capsys.readouterr().out
    assert both == info * 2


def _stdout(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn()
    return buf.getvalue(), result


def test_basic_example_prints_what_the_jax_example_prints():
    got, _ = _stdout(lambda: basic.main(device="cpu"))
    want, _ = _stdout(lambda: runpy.run_path(str(ROOT / "examples/basic.py")))
    assert got == want
    assert "'value': 'alfa'" in got and "stream: [] [" in got


@pytest.mark.parametrize("example", ["bulk_scan", "serving_loop"])
def test_examples_run_small_on_cpu(example):
    if example == "bulk_scan":
        text, counts = _stdout(lambda: bulk_scan.main(
            device="cpu", n_needles=64, doc_bytes=4096, n_docs=2,
            n_batches=2))
        assert len(counts) == 2 and min(counts) >= 1  # the planted needle
        assert text.count("batch ") == 2
    else:
        text, recs = _stdout(lambda: serving_loop.main(
            device="cpu", n_signatures=64, doc_bytes=1024, n_docs=8))
        assert [(r["keyIdx"], r["start_postion"]) for r in recs][:1] == [
            (42, 100)]
        assert "streamed 3x2 batches" in text
