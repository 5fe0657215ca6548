"""Whole runs: the command's refusals, the isolation from JAX, a sound
run, the control, and the faults the comparison must catch."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest


from .conftest import SMALL, run_small

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "php2048-resident", "--seed", "2147483700",
        "--seconds", "1", "--trace", "0"]


def _run_command(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", *ARGS], cwd=cwd,
        capture_output=True, text=True, timeout=300, env=env)


def test_command_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    r = _run_command(ROOT)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_command_refuses_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    r = _run_command(tmp_path, env)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_rehearsal_loads_no_jax():
    code = (
        "import sys, json\n"
        "from portbench.tests.conftest import run_small\n"
        "from portbench import run\n"
        "res = run_small('php2048-resident', seconds=0.2)\n"
        "print(json.dumps([res['correct'], run.forbidden_modules()]))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[true, []]"


def test_forbidden_names_compared_whole(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    monkeypatch.setitem(sys.modules, "php_aho_corasick_tpu_torch_x", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax"]


def test_sound_run_is_correct():
    res = run_small("php2048-resident")
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"scan_gbps", "call_ms_p95", "setup_s"}


def test_control_is_not_correct():
    res = run_small("php2048-resident", system="control")
    assert not res["correct"]
    assert res["checks"]["extra"]["value"] > 0


def _api():
    from php_aho_corasick_tpu_torch import api
    from php_aho_corasick_tpu_torch.models import cascade

    return api, cascade


def test_fault_half_the_batch_left_out(monkeypatch):
    api, _ = _api()
    real = api.Matcher.match_arrays_many

    def half(self, handles, find_all=True):
        out = real(self, handles[: len(handles) // 2], find_all)
        empty = {k: np.zeros(0, np.int64)
                 for k in ("doc", "pos", "start_postion", "pattern")}
        return out + [empty] * (len(handles) - len(out))

    monkeypatch.setattr(api.Matcher, "match_arrays_many", half)
    res = run_small("php2048-resident")
    assert not res["correct"] and res["checks"]["missing"]["value"] > 0


@pytest.mark.parametrize("cell", ["php2048-resident", "php2048-fresh-dense"])
def test_fault_answer_altered_where_produced(monkeypatch, cell):
    _, cascade = _api()
    real = cascade.CascadeModel.emit_records_arrays

    def shifted(self, *a, **k):
        docs, ends, pids = real(self, *a, **k)
        if ends.size:
            ends = ends.copy()
            ends[-1] += 1
        return docs, ends, pids

    monkeypatch.setattr(cascade.CascadeModel, "emit_records_arrays", shifted)
    res = run_small(cell)
    assert not res["correct"]
    assert res["checks"]["missing"]["value"] > 0
    assert res["checks"]["extra"]["value"] > 0


def test_fault_stale_answer(monkeypatch):
    api, _ = _api()
    real = api.Matcher.match_arrays
    first = {}

    def stale(self, haystacks, find_all=True):
        out = real(self, haystacks, find_all)
        return first.setdefault("out", out)

    monkeypatch.setattr(api.Matcher, "match_arrays", stale)
    res = run_small("php2048-fresh-dense")
    assert not res["correct"]


def test_fault_exchange_between_shards_left_out(monkeypatch):
    api, _ = _api()
    real = api.Matcher._gather_shard_records

    def shard0_only(groups):
        return real([(rc[:1], rp[:1], sizes[:1]) for rc, rp, sizes in groups])

    sound = run_small("php2048-mesh4-resident")
    assert sound["correct"]
    monkeypatch.setattr(api.Matcher, "_gather_shard_records",
                        staticmethod(shard0_only))
    res = run_small("php2048-mesh4-resident")
    assert not res["correct"] and res["checks"]["missing"]["value"] > 0


@pytest.mark.cuda
def test_resident_cell_small_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench import run
    from portbench.tests.conftest import SMALL

    res = run.run_cell("php2048-resident", 2**31 + 99, 1.0, True,
                       scale=SMALL["php2048-resident"],
                       log=lambda *a, **k: None)
    assert res["correct"]
    assert res["metrics"]["launches_per_call"]["value"] > 0
    assert 0 < res["metrics"]["filter_roofline_pct"]["value"] < 105


def test_open_loop_run_is_correct():
    scale = dict(SMALL["php2048-fresh-dense"])
    scale["traffic"] = dict(scale["traffic"],
                            loop={"kind": "open", "rate_per_s": 40})
    res = run_small("php2048-fresh-dense", seconds=0.5, scale=scale)
    assert res["correct"] and res["attempted"] >= 2


@pytest.mark.parametrize("how", [
    {"matcher": "per_call"},
    {"matcher": "saved"},
])
def test_matcher_modes_run_correct(how, tmp_path, monkeypatch):
    from portbench import system

    monkeypatch.setattr(system, "SAVED", tmp_path / "matchers")
    scale = dict(SMALL["php2048-fresh-dense"])
    scale["traffic"] = dict(scale["traffic"], **how)
    scale["needles"] = {"count": 2048, "length": 16, "alphabet": "abcdef",
                        "seed": 5}
    for _ in range(2 if how["matcher"] == "saved" else 1):
        res = run_small("php2048-fresh-dense", seconds=0.3, scale=scale)
        assert res["correct"] and res["attempted"] >= 1
    saved = list((tmp_path / "matchers").glob("*.npz"))
    assert len(saved) == (how["matcher"] == "saved")


@pytest.mark.parametrize("call", ["match_arrays_stream", "match_arrays"])
def test_resident_entries_run_correct(call):
    scale = dict(SMALL["php2048-resident"])
    per = 1 if call == "match_arrays" else 3
    scale["traffic"] = dict(scale["traffic"], call=call, units_per_call=per,
                            stream_batch=2)
    res = run_small("php2048-resident", seconds=0.3, scale=scale)
    assert res["correct"] and res["attempted"] >= 1


def test_fault_one_stream_batch_left_out(monkeypatch):
    api, _ = _api()
    real = api.Matcher.match_arrays_stream

    def first_only(self, handle_batches, find_all=True):
        batches = list(handle_batches)
        yield from real(self, batches[:1], find_all)

    monkeypatch.setattr(api.Matcher, "match_arrays_stream", first_only)
    scale = dict(SMALL["php2048-resident"])
    scale["traffic"] = dict(scale["traffic"], call="match_arrays_stream",
                            units_per_call=3, stream_batch=2)
    res = run_small("php2048-resident", seconds=0.3, scale=scale)
    assert not res["correct"] and res["checks"]["missing"]["value"] > 0


def test_mesh_cell_reports_the_program_mesh():
    res = run_small("php2048-mesh4-resident", seconds=0.2)
    assert res["correct"] and res["device"]["count"] == 4


def test_multi_card_cell_refuses_other_card_counts(monkeypatch):
    import torch

    from portbench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert run.require_cards(4) is not None
    assert run.require_cards(1) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert run.require_cards(4) is None
