"""Shared helpers of the benchmark's tests: cells run small on the CPU."""

import pytest

#: traffic small enough for the CPU, and still at least the 1 MiB a scan
#: needs to take the cascade
SMALL = {
    "php2048-resident": {"traffic": {"unit_bytes": 2 << 20,
                                     "resident_units": 3,
                                     "plants": {"per_byte": 2e-5}}},
    "php2048-fresh-dense": {"traffic": {"pool": 3, "docs_per_call": 160}},
    "php2048-mesh4-resident": {"traffic": {"unit_bytes": 2 << 20,
                                           "plants": {"per_byte": 2e-5}}},
}


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def run_small(cell, seed=2**31 + 77, seconds=0.5, scale=None, **kw):
    from portbench import run

    return run.run_cell(cell, seed, seconds, False, device="cpu",
                        scale=scale or SMALL[cell],
                        log=lambda *a, **k: None, **kw)
