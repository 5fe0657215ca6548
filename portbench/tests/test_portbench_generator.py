"""The generator: inputs follow the seed, sizes do not."""

import itertools

import numpy as np
import pytest

from portbench import generator, spec

CFG = {"needles": {"count": 300, "length": 16, "alphabet": "abcdef"},
       "content": {"alphabet": "abcdef"}}
RESIDENT = generator.params(
    {"units": "resident", "call": "match_arrays_many", "resident_units": 2,
     "units_per_call": 2, "doc_bytes": 1024, "unit_bytes": 64 * 1024,
     "plants": {"per_byte": 1e-3}}, {})
FRESH = generator.params(
    {"units": "fresh", "call": "match_arrays", "docs_per_call": 16,
     "doc_bytes": 512, "pool": 3, "plants": {"count": 7}}, {})


def test_same_seed_same_inputs():
    for p in (RESIDENT, FRESH):
        a = generator.generate(p, CFG, 2**31 + 5)
        b = generator.generate(p, CFG, 2**31 + 5)
        assert np.array_equal(a["needles"], b["needles"])
        assert all(np.array_equal(x, y) for x, y in zip(a["units"], b["units"]))


def test_other_seed_other_inputs_same_sizes():
    a = generator.generate(RESIDENT, CFG, 1)
    b = generator.generate(RESIDENT, CFG, 2)
    assert not np.array_equal(a["needles"], b["needles"])
    assert not np.array_equal(a["units"][0], b["units"][0])
    assert [u.shape for u in a["units"]] == [u.shape for u in b["units"]]
    assert a["planted"] == b["planted"] == [65, 65]


def test_needles_distinct_and_sorted():
    nd = generator.needles(CFG["needles"], 9)
    assert nd.shape == (300, 16)
    rows = [r.tobytes() for r in nd]
    assert rows == sorted(set(rows))
    assert set(np.unique(nd)) <= set(b"abcdef")


def test_needles_fixed_by_the_configuration():
    fixed = dict(CFG["needles"], seed=11)
    assert np.array_equal(generator.needles(fixed, 1),
                          generator.needles(fixed, 2))


def test_byte_alphabet_and_negative_seed():
    cfg = {"needles": {"count": 50, "length": 16, "alphabet": "byte"},
           "content": {"alphabet": "byte"}}
    g = generator.generate(FRESH, cfg, -3)
    assert g["units"][0].dtype == np.uint8 and g["planted"] == [7, 7, 7]


def test_content_keeps_to_the_alphabet():
    g = generator.generate(FRESH, CFG, 4)
    assert set(np.unique(np.concatenate(g["units"]))) <= set(b"abcdef")
    assert len(np.unique(g["units"][0])) == 6


def test_cells_draw_at_their_sizes():
    cell = spec.cell("php2048-resident")
    p = cell["traffic_params"]
    assert p["unit_bytes"] // p["doc_bytes"] == 16384
    assert p["resident_units"] * p["unit_bytes"] == 8 << 30


def test_calls_take_the_resident_units_in_turn():
    p = dict(RESIDENT, resident_units=3)
    assert [generator.call_units(p, i) for i in range(4)] == [
        [0, 1], [2, 0], [1, 2], [0, 1]]
    assert [generator.call_units(FRESH, i) for i in range(4)] == [
        [0], [1], [2], [0]]


def test_closed_loop_has_no_arrivals():
    assert generator.arrivals(RESIDENT, 3) is None


def test_open_loop_arrivals_follow_the_seed_at_the_rate():
    p = generator.params(FRESH, {"loop": {"kind": "open", "rate_per_s": 50}})
    n = generator.GAPS

    def first(seed):
        return np.array(list(itertools.islice(generator.arrivals(p, seed),
                                              n + 1)))

    a, b, c = first(7), first(7), first(8)
    assert a[0] == 0.0 and np.array_equal(a, b)
    assert not np.array_equal(a, c)
    # the same set of gaps for every seed, in another order
    assert np.allclose(np.sort(np.diff(a)), np.sort(np.diff(c)))
    assert abs(a[-1] / n - 1 / 50) < 0.05 / 50


@pytest.mark.parametrize("bad", [
    {"rate": 3},
    {"call": "match_arrays_many"},
    {"matcher": "per_call", "units": "resident",
     "call": "match_arrays_many"},
    {"loop": {"kind": "open"}},
    {"units": "streamed"},
])
def test_unfit_parameters_are_refused(bad):
    mix = {"units": "fresh", "call": "match_arrays", "docs_per_call": 4,
           "doc_bytes": 64, "pool": 1, "plants": {"count": 1}}
    with pytest.raises(ValueError):
        generator.params(mix, bad)
