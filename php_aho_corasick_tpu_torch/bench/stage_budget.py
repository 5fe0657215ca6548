"""Stage budget of the headline records pass: the JAX package's
``benchmarks/probe_stage_budget.py`` on the port.

On the headline workload (``bench.py``'s needles and 128 MiB resident
corpus), each row times 8 launches and one trailing synchronize by CUDA
events (the median of 3 such runs, the rows in turn in each round):

  prep     ``ops/filter_torch.fused_phase_grid``: the corpus word phases
           the fused filter reads (once a corpus on a resident handle)
  fused    ``ops/filter_cuda.fused_sampled_extract`` alone on the phases,
           with the records chain's arguments
           (``CascadeModel.fused_extract_args``)
  filter   ``CascadeModel.scan_hits_sampled`` end to end (prep, fused,
           the prefix refinement, survivor compaction)
  filterP  the same on the cached phases
  records  ``CascadeModel.launch_device_records`` (filter + records
           verify) on the cached phases
  public   ``match_arrays_many([handle] * 8)``: the headline's call

Deltas between rows are the stages' costs.  Beyond the reference's keys,
``spread`` gives each row's fastest and slowest run, ``launches`` its CUDA
kernel launches a call and ``busy`` the device's busy share of the public
row, both by ``torch.profiler`` (None on the CPU): host dispatch, not the
device, sets the pass, so ``records`` and ``public`` differ by little
more than their spreads.

    python -m php_aho_corasick_tpu_torch.bench.stage_budget [--device cpu]
        [--artifact PATH]

``run(mib=..., reps=...)`` cuts the corpus and the launches of a timed
run (the CPU tests run it small).
"""

from __future__ import annotations

import gc
import sys
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import Matcher, ScanConfig
from ..api import resolve_device
from ..ops import filter_cuda
from ..ops.filter_torch import fused_phase_grid
from . import _timing
from .headline import DOC_BYTES, MIB, corpus, draws

REPS, RUNS = 8, 3
ROWS = ("prep", "fused", "filter", "filterP", "records", "public")


def stages(m: Matcher, handle, reps: int = REPS) -> Dict[str, Callable]:
    """The rows' calls on ``handle``, each returning the device values it
    computed (``public``: the batch's result dicts)."""
    cm = m.cascade_model
    chunks, lengths, emit_from = (handle.chunks_d, handle.lengths_d,
                                  handle.emit_from_d)
    spc = cm.plan.stride // 4
    phase_g = handle.fused_phases(cm)
    args, kw = cm.fused_extract_args(chunks, lengths, phase_g)
    cap_a, cap_r = cm.learned_caps
    return {
        "prep": lambda: fused_phase_grid(chunks, spc=spc),
        "fused": lambda: filter_cuda.fused_sampled_extract(*args, **kw),
        "filter": lambda: cm.scan_hits_sampled(chunks, lengths, cap_a),
        "filterP": lambda: cm.scan_hits_sampled(chunks, lengths, cap_a,
                                                phase_g=phase_g),
        "records": lambda: cm.launch_device_records(
            chunks, lengths, emit_from, cap_a, cap_r, phase_g=phase_g),
        "public": lambda: m.match_arrays_many([handle] * reps),
    }


def records_arrays(m: Matcher, handle, out) -> dict:
    """The ``records`` row's device values ``(rec_cell, rec_pack, n, nr,
    nc)`` as a :meth:`Matcher.match_arrays` dict (one fetch, the host
    emission of ``match_arrays_many``)."""
    cm = m.cascade_model
    rc, rp, n, nr, nc = out
    cap_a, cap_r = cm.learned_caps
    n, nr, nc = (int(x) for x in (n, nr, nc))
    if n > cap_a or nr > cap_r or nc > cm._cap_coarse:
        raise RuntimeError(f"records row overflowed: {(n, nr, nc)}")
    if nr:
        arrays = cm.emit_records_arrays(handle.packed, rc[:nr].cpu().numpy(),
                                        rp[:nr].cpu().numpy(), nr)
    else:
        z = np.zeros(0, np.int64)
        arrays = (z, z, z)
    return m._arrays_result(handle.total_bytes, *arrays, find_all=True)


def rows_ms(device, calls: Dict[str, Callable],
            reps: int) -> Dict[str, List[float]]:
    """Ms a launch of each row in each of :data:`RUNS` rounds, ascending:
    a row's run is ``reps`` launches (the public row: one batch of ``reps``
    passes) and one trailing synchronize.  The rounds go over every row in
    turn, so the rows share the host's and the card's drift."""
    for fn in calls.values():
        fn()  # warm

    def run(row):
        if row == "public":
            calls[row]()
        else:
            for _ in range(reps):
                calls[row]()

    runs = {row: [] for row in calls}
    for _ in range(RUNS):
        for row in calls:
            runs[row].append(_timing.call_ms(device, lambda: run(row))[0]
                             / reps)
    return {row: sorted(t) for row, t in runs.items()}


def profile_row(device, fn: Callable) -> Tuple[Optional[int],
                                                Optional[float]]:
    """``(CUDA kernels launched, device busy ms)`` of one call of ``fn``
    by ``torch.profiler``; ``(None, None)`` off a card."""
    if device.type != "cuda":
        return None, None
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(device)
    n, busy_us = 0, 0.0
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            t = getattr(e, "self_device_time_total", None)
            busy_us += t if t is not None else e.self_cuda_time_total
            n += e.count
    return n, busy_us / 1e3


def run(mib: int = MIB, reps: int = REPS, device=None) -> dict:
    """The stage budget (``stage_budget_last.json``'s keys plus
    ``launches`` and ``busy``) on ``device`` (default: the CUDA card;
    raises with none)."""
    device = resolve_device(device)
    kernels = _timing.Kernels(device)
    needles, base_docs = draws()
    docs = corpus(base_docs, mib << 20)
    cfg = ScanConfig(backend="device", chunk_len=4096)
    m = Matcher([{"id": i, "value": p} for i, p in enumerate(needles)], cfg,
                device=device)
    m.finalize()
    cm = m.cascade_model
    if cm is None or cm.bloom_impl() != "pallas_vmem":
        raise RuntimeError("the headline set plans no bank-bloom cascade")
    print(f"plan: {cm.plan.reason} | records_ok: {cm.records_ok}",
          flush=True)
    handle = m.device_corpus(docs)
    if handle.fused_phases(cm) is None:
        raise RuntimeError("the fused filter's alignment gate fails")
    kernels.hold(lambda: m.match_arrays_many([handle]))
    want = m.match_arrays(handle)  # settles the capacities + warm
    m.match_arrays(handle)
    calls = stages(m, handle, reps)
    got = records_arrays(m, handle, calls["records"]())
    for key in want:
        if not np.array_equal(got[key], want[key]):
            raise RuntimeError(f"records row differs from match_arrays "
                               f"in {key!r}")

    gc.collect()
    runs = rows_ms(device, calls, reps)
    ms = {row: runs[row][RUNS // 2] for row in ROWS}
    spread = {row: [round(runs[row][0], 3), round(runs[row][-1], 3)]
              for row in ROWS}
    # launches and busy by the profiler, after every timed run: its events
    # are many Python objects, whose collection would land in a timing
    launches = {row: profile_row(device, calls[row])[0] for row in ROWS[:-1]}
    n, busy_ms = profile_row(device, calls["public"])
    launches["public"] = None if n is None else n / reps
    for row in ROWS:
        print(f"{row:>8}: {ms[row]:9.3f} ms/pass  {spread[row]}  "
              f"({launches[row]} kernel launches a call)", flush=True)
    total = len(docs) * DOC_BYTES
    print(f"stage deltas (ms): fused {ms['fused']:.3f}, prefix + compaction "
          f"{ms['filterP'] - ms['fused']:.3f}, records verify "
          f"{ms['records'] - ms['filterP']:.3f}, public glue "
          f"{ms['public'] - ms['records']:.3f}; public "
          f"{total / ms['public'] / 1e6:.2f} GB/s", flush=True)
    cap_a, cap_r = cm.learned_caps
    return {
        "ms": {k: round(v, 3) for k, v in ms.items()},
        "spread": spread,
        "cap_a": cap_a,
        "cap_r": cap_r,
        "mpr": cm.fused_extract_args(handle.chunks_d, handle.lengths_d,
                                     handle.fused_phases(cm))[1]["mpr"],
        "at": _timing.timestamp(),
        "launches": launches,
        "busy": None if busy_ms is None else busy_ms / reps / ms["public"],
        "device": _timing.card_line(device),
        "kernels": kernels.record(),
    }


def main(argv=None) -> int:
    ap = _timing.parser(__doc__.split("\n\n")[0])
    a = ap.parse_args(argv)
    _timing.finish(run(device=a.device), a.artifact)
    return 0


if __name__ == "__main__":
    sys.exit(main())
