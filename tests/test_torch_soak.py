"""The randomized soak (``php_aho_corasick_tpu_torch/soak.py``) on the CPU:
its cases pass against brute force, it catches a dropped record and
replays the case, its draws are the reference's
(``benchmarks/fuzz_soak.py``), and its check of every kernel launch
against the plain version catches a kernel that the exact verify
hides."""

import importlib.util
import json
import pathlib
import re

import pytest

torch = pytest.importorskip("torch")

from php_aho_corasick_tpu_torch import api, soak  # noqa: E402
from php_aho_corasick_tpu_torch.ops import _build  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEED = 3  # its first 20 cases scan through all five engine settings and skip
# on three refused routes


@pytest.fixture(autouse=True)
def _one_thread():
    # thousands of small torch ops slow down on a loaded OpenMP pool
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _is_reference_skip(reason):
    return reason == soak.BUILD_SKIP or any(
        w in reason for w in soak.SKIP_WORDS)


def test_fixed_seed_cases_pass_on_cpu():
    s = soak.run_cases(SEED, 20, "cpu")
    assert s["cases"] == 20 and s["scans"] >= 10, s
    assert s["skips"] and all(_is_reference_skip(r) for r in s["skips"]), s
    # the kernels count launches on the card only
    assert all(k["launches"] == 0 for k in s["kernels"].values()), s
    assert s["memory"] is None


def test_dropped_record_fails_and_replays(monkeypatch, capsys):
    real = api.Matcher.match_many

    def drop_one(self, *args, **kw):
        res = real(self, *args, **kw)
        for recs in res:
            if recs:
                recs.pop()
                break
        return res

    monkeypatch.setattr(api.Matcher, "match_many", drop_one)
    with pytest.raises(soak.SoakMismatch) as err:
        soak.run_cases(SEED, 20, "cpu")
    msg = str(err.value)
    case_seed = re.search(r"case seed (\d+):", msg).group(1)
    assert "config {" in msg and "bytes: got [" in msg and "want [" in msg
    with pytest.raises(soak.SoakMismatch, match=f"case seed {case_seed}:"):
        soak.main(["--replay", case_seed, "--device", "cpu"])
    monkeypatch.undo()
    assert soak.main(["--replay", case_seed, "--device", "cpu"]) == 0
    assert "{'ok': " in capsys.readouterr().out


def _reference():
    spec = importlib.util.spec_from_file_location(
        "fuzz_soak_reference", ROOT / "benchmarks" / "fuzz_soak.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_draws_equal_the_reference(monkeypatch):
    import random

    ref = _reference()
    seen = {}

    class Recorder:
        """Stands in for the reference's Matcher: keeps what one_case
        passes it, then refuses the scan as an ineligible route."""

        def __init__(self, specs, config):
            seen["patterns"] = [s["value"] for s in specs]
            seen["config"] = config

        def device_corpus(self, docs):
            seen["docs"], seen["handle"] = list(docs), True
            return self

        def match_many(self, tgt, find_all=True):
            if tgt is not self:
                seen["docs"], seen["handle"] = list(tgt), False
            seen["find_all"] = find_all
            raise ValueError("ineligible")

    monkeypatch.setattr(ref, "Matcher", Recorder)
    widened, shards = 0, set()
    for seed in range(12):
        seen.clear()
        assert ref.one_case(random.Random(seed)) == {"skipped": "ineligible"}
        case = soak.draw_case(seed)
        assert case["patterns"] == seen["patterns"], seed
        assert case["docs"] == seen["docs"], seed
        assert case["config"] == {
            k: getattr(seen["config"], k) for k in case["config"]}, seed
        assert (case["find_all"], case["use_handle"]) == (
            seen["find_all"], seen["handle"]), seed
        run = soak.run_config(case)
        assert run["table_format"] == (
            "compressed" if case["compressed"]
            else case["config"]["table_format"])
        widened += case["compressed"]
        assert (case["shards"] is None) == (not case["config"]["auto_shard"])
        shards.add(case["shards"])
    assert 0 < widened < 12
    assert shards == {None, *soak.SHARD_COUNTS}


def test_parent_runs_a_child_and_writes_artifact(tmp_path, capsys):
    art = tmp_path / "soak.json"
    assert soak.main(["--device", "cpu", "--seed", "1", "--total", "2",
                      "--artifact", str(art)]) == 0
    out = capsys.readouterr().out
    assert "SOAK OK: 2 cases, 0 mismatches" in out, out
    got = json.loads(art.read_text())
    assert (got["cases"], got["mismatches"], got["seed"]) == (2, 0, 1)
    assert set(got["kernels"]) == set(_build.KERNELS)
    assert got["card"] is None and got["device"] == "cpu"
    # two children's summaries add up
    part = {k: got[k] for k in ("cases", "scans", "skips", "kernels",
                                "memory")}
    both = soak.merge(soak.merge(None, part), part)
    assert (both["cases"], both["scans"]) == (4, 2 * got["scans"])
    assert all(both["skips"][r] == 2 * n for r, n in got["skips"].items())
    assert both["kernels"] == part["kernels"]  # all 0 on the CPU


def test_failed_child_names_its_seed_and_last_case(capsys):
    """A child that dies (here: scans on the meta device, whose results
    cannot be fetched) makes the parent exit 1 with the child's seed, the
    last case it started and the end of its output."""
    import random

    with pytest.raises(SystemExit) as err:
        soak.run_child(1, 2, "meta")
    assert err.value.code == 1
    out = capsys.readouterr().out
    first = random.Random(1).randrange(1 << 30)
    assert f"SOAK FAILURE in child seed 1 (exit 1), last case {first}; " \
        f"replay: PYTHONHASHSEED=0 python -m php_aho_corasick_tpu_torch." \
        f"soak --replay {first} --device meta" in out, out
    assert "NotImplementedError: Cannot copy out of meta tensor" in out, out


def test_soak_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        soak.main(["--total", "1"])


def _kernel_case(alpha, n_pat, lens, cfg):
    """A fixed case (no set order involved) whose scan calls one kernel
    wrapper: ``n_pat`` needles over ``alpha``, three documents with
    needles planted in them, ``cfg`` over a cascade default."""
    import random

    rng = random.Random(17)
    patterns = sorted({
        bytes(rng.choice(alpha) for _ in range(rng.randint(*lens)))
        for _ in range(n_pat)
    })
    docs = []
    for _ in range(3):
        d = bytearray(rng.choice(alpha) for _ in range(6000))
        for _ in range(20):
            p = rng.choice(patterns)
            pos = rng.randrange(0, len(d) - len(p))
            d[pos : pos + len(p)] = p
        docs.append(bytes(d))
    config = dict(backend="device", engine="cascade", auto_shard=False,
                  chunk_len=1024, match_capacity=256, cascade_mode="auto",
                  bloom_impl="auto", table_format="auto")
    config.update(cfg)
    return dict(seed=None, patterns=patterns, docs=docs, config=config,
                find_all=True, use_handle=False, compressed=False,
                shards=None)


#: per kernel: a case whose scan calls it, and a wrong output of the kind
#: a faulty kernel would give (the filters keep too much)
KERNEL_FAULTS = {
    "fused_sampled_extract": (
        (b"abcdefgh0123", 35, (16, 16),
         dict(chunk_len=1024, match_capacity=16)),
        lambda out: (*out[:3], out[3] ^ 1, out[4]),
    ),
    "bloom_word_vmem": (
        (b"ab", 100, (16, 16),
         dict(chunk_len=512, match_capacity=16, cascade_mode="sampled",
              bloom_impl="pallas_vmem")),
        lambda out: torch.full_like(out, -1),
    ),
    "bloom_hit": (
        (b"abcdef", 60, (8, 8), dict(cascade_mode="anchored")),
        torch.ones_like,
    ),
    "scan_states_tile": (
        (b"abcdefgh0123", 13, (4, 9), dict(engine="tile")),
        lambda out: (out[0] ^ 1, out[1]),
    ),
    "grouped_take_extract": (
        (b"abcdefgh0123", 35, (16, 16),
         dict(chunk_len=1024, match_capacity=16, bloom_impl="take")),
        lambda out: (*out[:3], out[3] ^ 1, out[4]),
    ),
    "grouped_take_refine": (
        (b"abcdefgh0123", 35, (16, 16),
         dict(chunk_len=1024, match_capacity=16, bloom_impl="take")),
        # alignment bit 0 added to every live hit: more windows walked
        lambda out: (out[0], torch.where(out[0] < 2**31 - 1, out[1] | 1,
                                         out[1]), out[2]),
    ),
    "flat_take_extract": (
        (b"abcdefgh0123", 35, (10, 10),  # stride 6: the flat take filter
         dict(chunk_len=1024, match_capacity=16, bloom_impl="take")),
        # alignment bit 0 added to every hit's long word
        lambda out: (out[0], torch.where(out[0] < 2**31 - 1, out[1] | 1,
                                         out[1]), *out[2:]),
    ),
}


def _as_plain(kernel, *args, **kw):
    return kernel.plain(*args, **kw)


@pytest.mark.parametrize("name", sorted(KERNEL_FAULTS))
def test_plain_check_catches_a_faulty_kernel(name, monkeypatch):
    """Every hand-kernel launch inside ``held_to_plain`` is held against
    the plain version: a wrong output shows as a difference, also where
    the exact verify trims it and the records still equal brute force.
    A card is stood in on the CPU: every call takes the kernels' route
    (``_build.on_card``), whose launch code here is the plain version, or
    for ``name`` a faulty one."""
    args, fault = KERNEL_FAULTS[name]
    case = _kernel_case(*args)
    monkeypatch.setattr(_build, "on_card", lambda t: True)
    for kernel in _build.KERNELS.values():
        monkeypatch.setattr(kernel, "code", _as_plain)
    with soak.held_to_plain() as err:
        assert "ok" in soak.run_case(case, "cpu")
    assert err == dict.fromkeys(_build.KERNELS, 0)
    calls = []

    def faulty(kernel, *a, **kw):
        calls.append(1)
        return fault(kernel.plain(*a, **kw))

    monkeypatch.setattr(_build.KERNELS[name], "code", faulty)
    with soak.held_to_plain() as err:
        try:
            got = soak.run_case(case, "cpu")
        except soak.SoakMismatch:  # the tile walk's states feed the records
            got = None
    assert calls and err[name] > 0, err
    assert all(d == 0 for n, d in err.items() if n != name), err
    if name != "scan_states_tile":
        assert "ok" in got  # brute force alone would not see it
    # the context leaves nothing observing
    assert not _build._observers
    monkeypatch.undo()
    assert not any(_build.launch_counts().values())


def test_merge_keeps_the_largest_difference():
    def part(d):
        return dict(cases=1, scans=1, skips={}, memory=None, kernels={
            n: {"cases": 1, "launches": 2, "max_abs_err": d}
            for n in _build.KERNELS})

    both = soak.merge(soak.merge(None, part(0)), part(3))
    assert all(k == {"cases": 2, "launches": 4, "max_abs_err": 3}
               for k in both["kernels"].values()), both
