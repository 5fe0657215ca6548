"""Run one cell of the port's benchmark once and print its result.

    python3 -m portbench.run --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout.  The run sets up (inputs drawn from the seed,
the matcher built and planned, the corpus uploaded, every shape of the
cell warmed), then calls the system for ``--seconds`` as the cell's mix
says (a closed loop with one client, or an open loop of arrivals at a
fixed rate; ``generator.py``), then compares every call's records with
the plain reference.  The last line of standard output is one JSON object:
``correct``, ``attempted`` (calls), ``failed`` (calls whose records
differ), ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number compared with its limit.

With ``--trace 1`` the run wraps the stage entry points that the cell's
per-layer metrics name in spans, and profiles a fixed slice of
:data:`PROFILE_CALLS` calls after the window.

It exits with another code than 0, printing no result, when no CUDA card
is there or fewer than the cell asks for, or when JAX or the JAX package
was loaded.
"""

from __future__ import annotations

import sys
import time

_T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: top-level module names that must never be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "php_aho_corasick_tpu")
#: calls profiled in a traced run, after its window
PROFILE_CALLS = 4


def process_age() -> float:
    """Seconds since this process started (``/proc``), or since this
    module was imported where ``/proc`` is missing."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


def use_bytecode_cache() -> None:
    """Keep compiled bytecode of every module in ``build/pycache`` inside
    the checkout, so that only a checkout's first run compiles torch's
    sources (the environment may turn bytecode writes off)."""
    sys.pycache_prefix = str(ROOT / "build" / "pycache")
    sys.dont_write_bytecode = False


def use_one_cpu_thread() -> None:
    """One thread for torch's CPU operators: the run is one client, and
    idle worker threads that spin on the host's shared cores take time
    from the thread that dispatches to the card."""
    import torch

    torch.set_num_threads(1)


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def card_state(chips: int) -> List[str]:
    """Each card's name, clocks, power, limit and temperature."""
    q = ("index,name,clocks.sm,clocks.mem,power.draw,power.limit,"
         "temperature.gpu")
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return [f"nvidia-smi: {e}"]
    return out.stdout.strip().splitlines()[:chips]


class RunData:
    """What a metric's reader reads: the window's calls, set-up, the
    spans, the counters and the reduced profile."""

    def __init__(self, **kw) -> None:
        self.__dict__.update(kw)


def _note_plan(plan: dict, expect: dict) -> List[str]:
    return [f"{k}: configuration states {v!r}, program planned "
            f"{plan.get(k)!r}" for k, v in expect.items()
            if plan.get(k) != v]


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", system: str = "program",
             scale: Optional[dict] = None, log=print) -> dict:
    """One run of ``workload``; returns the result object.

    ``scale`` overrides the cell's traffic parameters and the
    configuration's needles, scan settings and expectations (the tests run
    cells small on the CPU)."""
    import numpy as np
    import torch

    from . import check, generator, spec, system as systems
    from .reference.matcher import Needles, find
    from .trace import Spans, reduce_profile

    bench = spec.benchmark()
    cell = spec.cell(workload)
    config = spec.config(cell["config"])
    params = cell["traffic_params"]
    if scale:
        params = generator.params(params, scale.get("traffic", {}))
        for key in ("needles", "scan_config", "expect"):
            if key in scale:
                config = dict(config, **{key: scale[key]})
    chips = cell["chips"]
    wanted = spec.metrics_of(bench, workload, trace)
    readers = {m["name"]: spec.metric_module(m["name"]) for m in wanted}

    spans = Spans()
    installed = spans.install(spec.spans_of(readers)) if trace else None
    if installed is not None:
        installed.__enter__()
    try:
        gen_dev = "cpu" if device == "cpu" else "cuda:0"
        inputs = generator.generate(params, config, seed, gen_dev)
        unit_bytes = [int(u.size) for u in inputs["units"]]
        sut = systems.SYSTEMS[system](config, params, chips, device)
        sut.build(inputs["needles"])
        plan = sut.plan()
        if system == "program":
            wrong = _note_plan(plan, config.get("expect", {}))
            if wrong:
                raise RuntimeError("the program left the configured path: "
                                   + "; ".join(wrong))
        sut.load(inputs["units"])
        n_cards = sut.cards()

        # warm every shape of the cell until the capacities settle
        sut.warm()
        quiet, tries = 0, 0
        while quiet < 2 and tries < 4 * max(len(inputs["units"]), 4):
            r0 = sut.retries()
            sut.call(tries)
            quiet = quiet + 1 if sut.retries() == r0 else 0
            tries += 1
        sut.sync()
        gc.collect()
        gc.freeze()
        setup_s = process_age()

        # the window: calls as the mix issues them
        spans.phase = "window"
        calls: List[tuple] = []
        outputs: List[tuple] = []

        def one_call(i: int, arrived: Optional[float] = None) -> None:
            ts = time.perf_counter()
            with spans.span("call") if trace else contextlib.nullcontext():
                units, results = sut.call(i)
            te = time.perf_counter()
            calls.append((ts if arrived is None else arrived, te,
                          sum(unit_bytes[k] for k in units)))
            outputs.append((units, results))

        arrivals = generator.arrivals(params, seed)
        retries0 = sut.retries()
        t0 = time.perf_counter()
        if arrivals is None:
            # closed: the next call as soon as the last has returned
            while not calls or time.perf_counter() - t0 < seconds:
                one_call(len(calls))
        else:
            # open: each call at its arrival, or once the one before it
            # has returned; its latency counts from the arrival
            for at in arrivals:
                if calls and at >= seconds:
                    break
                wait = t0 + at - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                one_call(len(calls), t0 + at)
        n_window = len(calls)
        window_s = calls[-1][1] - t0
        retries = sut.retries() - retries0
        window_calls = calls[:]

        prof = None
        if trace:
            # a fixed slice of calls after the window, profiled
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if device != "cpu":
                acts.append(ProfilerActivity.CUDA)
            sut.sync()
            spans.phase = "slice"
            with profile(activities=acts) as prof:
                with torch.profiler.record_function("pb:slice"):
                    for _ in range(PROFILE_CALLS):
                        one_call(len(calls))
                    sut.sync()
        peak = 0
        if device != "cpu":
            peak = max(torch.cuda.max_memory_allocated(d) for d in sut.devices)
        kind = (torch.cuda.get_device_name(sut.devices[0])
                if device != "cpu" else "cpu")
        spans.phase = "after"
    finally:
        if installed is not None:
            installed.__exit__(None, None, None)
    if device != "cpu":
        for line in card_state(chips):
            log(f"card after the window: {line}", file=sys.stderr)
    profile_data = None
    if prof is not None:
        profile_data = reduce_profile(prof.profiler.kineto_results.events(),
                                      PROFILE_CALLS)
        del prof
        log(f"profile: {profile_data['device_ops']} device operations in "
            f"the slice, {profile_data['linked_ops']} with their launch found",
            file=sys.stderr)
    timings = dict(sut.timings)
    sut.close()
    del sut

    # the reference, once the program's state is freed
    gc.unfreeze()
    t_ref = time.perf_counter()
    ref_dev = "cpu" if device == "cpu" else "cuda:0"
    needle_list = [r.tobytes() for r in inputs["needles"]]
    ref_needles = Needles(needle_list, ref_dev)
    # each unit that some call scanned, once
    refs = {k: find(inputs["units"][k], ref_needles)
            for k in sorted({k for units, _ in outputs for k in units})}
    del ref_needles
    lens = np.array([len(n) for n in needle_list], np.int64)
    cmp = check.compare_calls(outputs, refs, lens)
    numbers = cmp["numbers"]
    log(f"reference and comparison {time.perf_counter() - t_ref:.3f} s",
        file=sys.stderr)

    data = RunData(
        calls=window_calls, window_s=window_s, setup_s=setup_s, spans=spans,
        profile=profile_data, retries=retries, config=config, cell=cell,
        params=params, plan=plan, timings=timings, n_calls=n_window,
    )
    metrics: Dict[str, dict] = {}
    for m in wanted:
        value = readers[m["name"]].read(data)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_rec = {"platform": "gpu" if device != "cpu" else "cpu",
               "kind": kind, "count": n_cards, "memory_peak_bytes": peak}
    if profile_data is not None:
        busy = profile_data["busy_us"]
        dev_rec["busy_s"] = (sum(busy.values()) / max(len(busy), 1)) / 1e6
        dev_rec["window_s"] = profile_data["window_us"] / 1e6
    result = {
        "correct": check.passed(numbers) and cmp["failed"] == 0,
        "attempted": len(outputs),
        "failed": cmp["failed"],
        "metrics": metrics,
        "device": dev_rec,
    }
    if profile_data is not None:
        result["breakdown"] = {"device_ops": profile_data["top_ops"],
                               "idle_gaps": profile_data["gaps"]}
    result["checks"] = {k: {"value": v, "limit": check.LIMITS[k]}
                        for k, v in numbers.items()}
    log(f"set-up {setup_s:.3f} s, {n_window} calls in {window_s:.3f} s, "
        f"{retries} capacity retries, planted {sum(inputs['planted'])}, "
        f"plan {plan}", file=sys.stderr)
    return result


def require_cards(chips: int) -> Optional[str]:
    import torch

    if not torch.cuda.is_available():
        return "no CUDA card is available"
    n = torch.cuda.device_count()
    if n < chips or (chips > 1 and n != chips):
        # a sharded scan spreads over every visible card
        return f"the cell needs {chips} cards, {n} are visible"
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--system", choices=("program", "control"),
                    default="program",
                    help="'control' puts the reference, with the "
                         "exactness guarantee broken, in the program's "
                         "place (to show the comparison fails it)")
    a = ap.parse_args(argv)
    use_bytecode_cache()
    use_one_cpu_thread()
    try:
        import php_aho_corasick_tpu_torch  # noqa: F401

        from . import spec

        chips = spec.cell(a.workload)["chips"]
    except (ImportError, OSError, ValueError, KeyError) as e:
        print(f"cannot set the run up: {e!r}", file=sys.stderr)
        return 2
    why = require_cards(chips)
    if why:
        print(why, file=sys.stderr)
        return 3
    result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                      system=a.system, log=print)
    found = forbidden_modules()
    if found:
        print(f"modules that a run must not load were loaded: {found}",
              file=sys.stderr)
        return 4
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
