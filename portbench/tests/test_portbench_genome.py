"""The genome cell (``gecko2-grch38-resident``), the 128 MiB fresh cell
(``php2048-fresh-128m``) and the readers of their per-layer metrics
(``take_filter_roofline_pct``, ``filter_hits_per_mb``,
``verify_device_us_per_call``): small runs on the CPU, and each reader on
a run that has its numbers and on one that has not (a program without
the ``filter_hits`` counter, a profile without the spans)."""

import pytest

from portbench import spec
from portbench.run import RunData
from portbench.trace import Spans

#: the cells small enough for the CPU; the genome's needles plan the
#: full library's q=15, stride 6 flat take filter at 4,096 needles with
#: ``cascade_min_q`` 15 (the default picks stride 8 there)
SMALL = {
    "gecko2-grch38-resident": {
        "traffic": {"doc_bytes": 1_200_000, "unit_bytes": 1_200_000,
                    "resident_units": 3, "units_per_call": 3,
                    "plants": {"count": 40}},
        "needles": {"count": 4096, "length": 20, "alphabet": "ACGT"},
        "scan_config": {"backend": "device", "chunk_len": 4096,
                        "bloom_impl": "take", "cascade_min_q": 15},
        "expect": {"engine": "cascade", "plan.q": 15, "plan.stride": 6,
                   "bloom_impl": "take", "records_ok": True},
    },
    "php2048-fresh-128m": {"traffic": {"pool": 2, "docs_per_call": 160,
                                       "plants": {"per_byte": 2e-5}}},
}


def _run(cell, trace, seed=2**33 + 41, seconds=0.4, system="program"):
    from portbench import run

    return run.run_cell(cell, seed, seconds, trace, device="cpu",
                        scale=SMALL[cell], system=system,
                        log=lambda *a, **k: None)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_cell_runs_correct_and_counts_filter_hits(cell):
    res = _run(cell, False)
    assert res["correct"] and res["attempted"] >= 1
    assert set(res["metrics"]) == {"scan_gbps", "call_ms_p95", "setup_s"}
    res = _run(cell, True)
    assert res["correct"]
    # the CPU has no device trace: the two device readers find nothing
    assert set(res["metrics"]) == {"filter_hits_per_mb"}
    assert res["metrics"]["filter_hits_per_mb"]["value"] > 0


def test_genome_control_is_not_correct():
    res = _run("gecko2-grch38-resident", False, system="control")
    assert not res["correct"] and res["checks"]["extra"]["value"] > 0


def test_genome_cell_states_the_configuration():
    cell = spec.cell("gecko2-grch38-resident")
    p = cell["traffic_params"]
    assert p["resident_units"] * p["unit_bytes"] == 3_096_000_000
    assert p["units_per_call"] == p["resident_units"]
    cfg = spec.config(cell["config"])
    assert cfg["needles"]["count"] == 2 * 123_411 and cfg["reduced"] == []


def _run_data(notes=(), profile=None, calls=((0.0, 1.0, 2_000_000),)):
    spans = Spans()
    spans.phase = "window"
    for n in notes:
        spans.add("program.filter_hits", 0.0, 0.0, n)
    return RunData(calls=list(calls), n_calls=len(calls), spans=spans,
                   profile=profile)


def test_filter_hits_reader():
    mod = spec.metric_module("filter_hits_per_mb")
    calls = [(0.0, 1.0, 2_000_000), (1.0, 2.0, 2_000_000)]
    assert mod.read(_run_data([100, 500], calls=calls)) == 100.0
    # a program without the counter notes None, which is no note
    assert mod.read(_run_data([None, None], calls=calls)) is None
    assert mod.read(_run_data([], calls=calls)) is None


def test_verify_device_reader():
    mod = spec.metric_module("verify_device_us_per_call")
    prof = {"spans": {"verify": {"device_us": 120.0, "ops": 8, "count": 4}},
            "calls": 4}
    assert mod.read(_run_data(profile=prof)) == 30.0
    assert mod.read(_run_data(profile={"spans": {}, "calls": 4})) is None
    assert mod.read(_run_data()) is None


def test_take_filter_roofline_reader():
    from portbench.bounds import sampled_filter_work

    mod = spec.metric_module("take_filter_roofline_pct")
    work = sampled_filter_work(31_496, 4224, 15, 6, 1 << 30, 6)
    run = _run_data(profile={"spans": {"take_filter": {
        "device_us": 1000.0, "ops": 40, "count": 1}}, "calls": 4})
    run.spans.phase = "slice"
    run.spans.add("take_filter", 0.0, 0.0, work)
    got = mod.read(run)
    assert got == pytest.approx(100.0 * work["seconds"] * 1e6 / 1000.0)
    assert 0 < got < 100
    assert mod.read(_run_data(profile={"spans": {}, "calls": 4})) is None
