"""The benchmark's files: every piece loads, keeps to the allowed names,
and is found by name."""

import json
import shutil

import pytest

from portbench import spec

BENCH = spec.benchmark()


def test_benchmark_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_loads(c):
    assert spec.NAME.match(c["name"])
    cfg = spec.config(c["name"])
    assert c["file"] == f"portbench/configs/{c['name']}.json"
    assert cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"]
    for key in ("needles", "content", "scan_config", "guarantees", "expect",
                "control"):
        assert key in cfg


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_file_loads_and_agrees(w):
    assert spec.NAME.match(w["name"]) and spec.NAME.match(w["traffic"])
    cell = spec.cell(w["name"])
    for key in ("config", "traffic", "chips", "why"):
        assert cell[key] == w[key]
    own = json.loads((spec.HERE / "workloads" / f"{w['name']}.json")
                     .read_text())
    assert set(own) == {"params"}  # the cell is declared once
    assert w["chips"] in (1, 4)
    assert len(w["why"]) <= 200 and "\n" not in w["why"]
    assert cell["traffic_params"]["units"] in ("resident", "fresh")


@pytest.mark.parametrize(
    "m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_loads(m):
    assert spec.NAME.match(m["name"])
    assert spec.UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    mod = spec.metric_module(m["name"])
    assert callable(mod.read)
    for w in m.get("workloads", []):
        assert spec.bench_cell(BENCH, w) is not None


def test_every_cell_reports_what_it_must():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in spec.metrics_of(BENCH, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics_of(BENCH, w["name"], True)


def test_per_layer_moves_a_reported_metric():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e


def test_new_cell_file_is_found_by_name(tmp_path):
    here = tmp_path / "portbench"
    shutil.copytree(spec.HERE / "configs", here / "configs")
    shutil.copytree(spec.HERE / "traffic", here / "traffic")
    shutil.copytree(spec.HERE / "workloads", here / "workloads")
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append(
        {"name": "php2048-fresh-small", "config": "php-bench-2048x16",
         "traffic": "fresh_batch", "chips": 1,
         "why": "a cell added as one file and one entry"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (here / "workloads" / "php2048-fresh-small.json").write_text(
        json.dumps({"params": {"docs_per_call": 64}}))
    assert "php2048-fresh-small" in spec.cell_names(here)
    cell = spec.cell("php2048-fresh-small", here, tmp_path)
    assert cell["traffic_params"]["docs_per_call"] == 64
    assert cell["traffic_params"]["pool"] == 64  # the mix's own value
    assert cell["chips"] == 1


def test_unknown_traffic_parameter_is_refused():
    from portbench.generator import params

    with pytest.raises(ValueError):
        params({"units": "fresh", "call": "match_arrays"}, {"rate": 3})


def test_bad_names_are_refused():
    with pytest.raises(ValueError):
        spec.cell("../BENCHMARK")
    with pytest.raises(ValueError):
        spec.metric_module("a b")
