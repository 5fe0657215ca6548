"""The port's profiling hooks: ``automaton_dot`` string-equal to the JAX
package's, ``trace`` writing a profiler trace on the CPU, ``sync``'s
checksum and ``Timer``'s laps."""

import json
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import php_aho_corasick_tpu as ref  # noqa: E402
from php_aho_corasick_tpu.utils import profiling as ref_prof  # noqa: E402

import php_aho_corasick_tpu_torch as port  # noqa: E402
from php_aho_corasick_tpu_torch.utils import profiling  # noqa: E402


@pytest.mark.parametrize("seed", range(3))
def test_automaton_dot_equals_jax(seed):
    rng = random.Random(seed)
    pats = sorted({bytes(rng.choice(b"ab\x00c\xff")
                         for _ in range(rng.randint(1, 5)))
                   for _ in range(12)})
    specs = [{"value": p} for p in pats]
    mt = port.Matcher(specs, device="cpu")
    mj = ref.Matcher(specs)
    dot = profiling.automaton_dot(mt.automaton)
    assert dot == ref_prof.automaton_dot(mj.automaton)
    assert dot.startswith("digraph automaton {") and "0x00" in dot
    with pytest.raises(ValueError, match="too large"):
        profiling.automaton_dot(mt.automaton, max_states=2)


def test_trace_writes_a_profiler_trace(tmp_path):
    x = torch.arange(1000, dtype=torch.float32)
    with profiling.trace(str(tmp_path)):
        y = (x * 2).sum()
    assert float(y) == 999000.0
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mul" for e in events)


def test_sync_and_timer():
    a = torch.arange(10, dtype=torch.int32)
    b = np.ones((3, 4), np.uint8)
    assert profiling.sync(a, b) == 45.0 + 12.0
    assert profiling.sync() == 0.0
    t = profiling.Timer()
    assert t.lap("a") >= 0.0 and t.lap("a") >= 0.0 and t.lap("b") >= 0.0
    assert sorted(t.laps) == ["a", "b"]
