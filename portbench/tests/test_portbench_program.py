"""The readers of the program's own spans and wait counter
(``portbench/program.py``): a traced run on the CPU reports them in the
cells that list them, an untraced run records nothing, and the
program's ``aho:`` ranges (host ranges with no device side) leave the
profile's reduction as it was."""

import pytest

from .conftest import SMALL

NEW = ("chain_dispatch_ms_per_call", "host_wait_ms_per_call",
       "host_waits_per_call", "corpus_load_s")


def _traced(cell, seed=2**31 + 123, seconds=0.4):
    from portbench import run

    return run.run_cell(cell, seed, seconds, True, device="cpu",
                        scale=SMALL[cell], log=lambda *a, **k: None)


@pytest.mark.parametrize("cell,waits,load", [
    ("php2048-resident", 2, True),
    ("php2048-fresh-dense", 3, False),
    ("php2048-mesh4-resident", 2, True),
])
def test_traced_run_reads_the_program(cell, waits, load):
    res = _traced(cell)
    assert res["correct"]
    got = {k: v["value"] for k, v in res["metrics"].items() if k in NEW}
    assert got["host_waits_per_call"] == waits
    assert got["chain_dispatch_ms_per_call"] > 0
    assert got["host_wait_ms_per_call"] > 0
    assert ("corpus_load_s" in got) == load
    if load:
        assert got["corpus_load_s"] > 0
    assert res["metrics"]["host_waits_per_call"]["unit"] == "waits/call"


def test_counter_repeats_across_runs():
    a = _traced("php2048-resident", seed=2**31 + 1)
    b = _traced("php2048-resident", seed=2**31 + 2)
    assert (a["metrics"]["host_waits_per_call"]["value"]
            == b["metrics"]["host_waits_per_call"]["value"] == 2)


def test_untraced_run_records_nothing():
    from php_aho_corasick_tpu_torch.utils import profiling

    from portbench import program

    from .conftest import run_small

    program.stop()  # a traced run before this one leaves it on
    assert profiling._active is None
    res = run_small("php2048-resident", seconds=0.2)
    assert res["correct"] and profiling._active is None


def test_no_recorder_reads_nothing(monkeypatch):
    from portbench import program
    from portbench.run import RunData

    monkeypatch.setattr(program, "RECORDING", None)
    run = RunData(calls=[(0.0, 1.0, 8)], n_calls=1, spans=None)
    assert program.window_ms_per_call(run, {"chain"}) is None
    assert program.setup_seconds(run, {"pack"}) is None


class _Event:
    """What ``trace._raw_events`` reads of a profiler event."""

    def __init__(self, name, cuda, start_us, dur_us, corr=0, linked=0,
                 dev=0):
        self._v = (name, cuda, start_us, dur_us, corr, linked, dev)

    def name(self):
        return self._v[0]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[1] else "DeviceType.CPU"

    def device_index(self):
        return self._v[6]

    def start_ns(self):
        return int(self._v[2] * 1000)

    def duration_ns(self):
        return int(self._v[3] * 1000)

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


def _slice(with_program):
    ev = [
        _Event("pb:slice", False, 0, 1000),
        _Event("pb:call", False, 10, 900),
        _Event("pb:filter", False, 20, 100),
        _Event("pb:filter", True, 50, 60),  # its device-side annotation
        _Event("cudaLaunchKernel", False, 30, 5, corr=1),
        _Event("fused_sampled_extract_kernel", True, 50, 40, corr=1),
        _Event("cudaLaunchKernel", False, 200, 5, corr=2),
        _Event("vectorized_elementwise_kernel", True, 210, 30, corr=2),
        _Event("cudaMemcpyAsync", False, 600, 5, corr=3),
        _Event("Memcpy DtoH", True, 700, 20, corr=3, dev=0),
    ]
    if with_program:
        ev += [
            _Event("aho:call", False, 11, 890),
            _Event("aho:dispatch", False, 12, 400),
            _Event("aho:chain@cuda:0", False, 15, 300),
            _Event("aho:filter", False, 21, 90),
            _Event("aho:wait", False, 500, 250),
        ]
    return ev


def test_program_ranges_leave_the_reduction_as_it_was():
    from portbench.trace import reduce_profile

    plain = reduce_profile(_slice(False), 4)
    both = reduce_profile(_slice(True), 4)
    for key in ("device_ops", "busy_us", "spans", "window_us",
                "linked_ops", "top_ops", "gaps"):
        assert both[key] == plain[key], key
    assert plain["device_ops"] == 3
    assert plain["spans"]["filter"]["ops"] == 1
