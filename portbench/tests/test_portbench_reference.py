"""The plain reference against brute force, and its independence."""

import ast
from pathlib import Path

import numpy as np
import pytest

from portbench.reference.matcher import Needles, brute, find


def _records(r):
    return list(zip(r["doc"].tolist(), r["pos"].tolist(),
                    r["pattern"].tolist()))


@pytest.mark.parametrize("seed", range(6))
def test_find_equals_brute_force(seed):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ab", np.uint8)
    docs = alpha[rng.integers(0, 2, (7, 200))]
    lens = rng.integers(1, 12, 25)
    needles = sorted({alpha[rng.integers(0, 2, k)].tobytes() for k in lens})
    got = find(docs, Needles(needles))
    want = brute([d.tobytes() for d in docs], needles)
    assert _records(got) == want
    assert np.array_equal(got["start"],
                          got["pos"] - np.array([len(n) for n in needles])[got["pattern"]])


def test_overlaps_and_document_ends():
    docs = np.frombuffer(b"aaaa" + b"abab", np.uint8).reshape(2, 4)
    needles = [b"aa", b"ab", b"ba", b"aaa"]
    got = _records(find(docs, Needles(needles)))
    assert got == brute([b"aaaa", b"abab"], needles)
    assert (0, 3, 3) in got and (0, 4, 3) in got  # overlapping "aaa"
    assert not any(d == 0 and p == 1 for d, _, p in got)  # no "ab" across


def test_lengths_cut_documents():
    docs = np.frombuffer(b"xxab" + b"abxx", np.uint8).reshape(2, 4)
    got = _records(find(docs, Needles([b"ab"]), lengths=np.array([3, 4])))
    assert got == [(1, 2, 0)]


def test_control_reports_prefix_matches():
    docs = np.frombuffer(b"abcxabdx", np.uint8).reshape(1, 8)
    exact = _records(find(docs, Needles([b"abc"])))
    loose = _records(find(docs, Needles([b"abc"], prefix_bytes=2)))
    assert exact == [(0, 3, 0)]
    assert loose == [(0, 3, 0), (0, 7, 0)]


def test_reference_imports_nothing_of_the_system():
    bad = {"php_aho_corasick_tpu_torch", "php_aho_corasick_tpu", "jax",
           "jaxlib", "flax"}
    for path in (Path(__file__).parents[1] / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in bad, (path.name, n)
