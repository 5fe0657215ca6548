"""Randomized soak: the port's public API against brute force.

Counterpart of the JAX package's ``benchmarks/fuzz_soak.py``.  Each case
draws a needle set, a few documents with needles planted in them and a
random :class:`ScanConfig` (engine x ``chunk_len`` x capacity x
``cascade_mode`` x ``bloom_impl`` x ``table_format`` x ``find_all`` x
handles x ``auto_shard``), scans the documents with ``match_many`` on the
device and compares ``(pos, keyIdx)`` with :func:`brute`.  On a card the
random public calls reach the hand kernels (``ops/_build.KERNELS``) at
random shapes: the module reports how many cases launched each one, and
holds every launch against the kernel's plain version on the same inputs
(:func:`held_to_plain`).

    python -m php_aho_corasick_tpu_torch.soak [--seconds 600] [--seed 0]
    python -m php_aho_corasick_tpu_torch.soak --device cpu --seconds 60
    python -m php_aho_corasick_tpu_torch.soak --replay CASE_SEED

It runs on CUDA unless ``--device cpu`` is given, and raises with no
card.  The parent process runs the cases in children of ``--cases``
each: a CUDA fault (an illegal address) ends its process for good, so
the child dies alone and the parent reports the child's seed and the
last case it started.  ``--total N`` stops after ``N`` cases.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import random
import subprocess
import sys
import time
from typing import Optional

#: the words of a scan-time ``ValueError`` that the reference counts as a
#: refused route rather than a failure (``benchmarks/fuzz_soak.py:80``)
SKIP_WORDS = ("ineligible", "requires", "exceeds")
#: the reason the reference gives a ``ValueError`` from building the
#: matcher (``benchmarks/fuzz_soak.py:76``)
BUILD_SKIP = "forced-engine ineligible"
#: shards of the one device that an ``auto_shard`` case runs on (the
#: reference's sweep ran an 8-device CPU mesh)
SHARD_COUNTS = (2, 4)
CHILD_TIMEOUT_S = 1800
#: the needle list is the reference's ``list(set)``, whose order (and so
#: the plants drawn from it) follows the process's bytes hash: children
#: run with this hash seed, so a case replays exactly under it
REPLAY_HASH_SEED = "0"
SWEEP = ("engines x chunk_len x capacity x cascade_mode x bloom_impl x "
         "table_format (compressed widened) x find_all x handles x "
         "auto_shard (local_shards 2 or 4 of the device)")


class SoakMismatch(AssertionError):
    """A case whose records differ from brute force."""


def brute(patterns, text):
    out = []
    for pid, p in enumerate(patterns):
        s = text.find(p)
        while s != -1:
            out.append((s + len(p), -len(p), pid))
            s = text.find(p, s + 1)
    out.sort()
    return [(pos, pid) for pos, _, pid in out]


def draw_case(seed: int) -> dict:
    """The case of ``seed``: the reference's ``one_case`` draws from
    ``random.Random(seed)`` in its order (needles, documents, config,
    ``find_all``, the handle), then two widened draws from a second
    stream seeded from ``seed``: ``compressed`` (about a third of the
    cases run ``table_format="compressed"``) and ``shards`` (the shard
    count of an ``auto_shard`` case, else None)."""
    rng = random.Random(seed)
    alpha = rng.choice([b"ab", b"abcdef", b"abcdefgh0123", bytes(range(256))])
    n_pat = rng.randint(1, 120)
    lens = rng.choice([(1, 4), (4, 9), (9, 20), (1, 20), (16, 16)])
    patterns = list({
        bytes(rng.choice(alpha) for _ in range(rng.randint(*lens)))
        for _ in range(n_pat)
    })
    n_docs = rng.randint(1, 6)
    docs = []
    for _ in range(n_docs):
        d = bytearray(
            rng.choice(alpha) for _ in range(rng.randint(0, 12000))
        )
        for _ in range(rng.randint(0, 30)):
            p = rng.choice(patterns)
            if len(d) > len(p):
                pos = rng.randrange(0, len(d) - len(p))
                d[pos : pos + len(p)] = p
        docs.append(bytes(d))
    cfg = dict(
        backend="device",
        engine=rng.choice(["auto", "dfa", "kgram", "cascade", "tile"]),
        auto_shard=rng.random() < 0.5,
        chunk_len=rng.choice([256, 512, 1024, 4096]),
        match_capacity=rng.choice([16, 256, 4096]),
        cascade_mode=rng.choice(["auto", "sampled", "anchored"]),
        bloom_impl=rng.choice(["auto", "take", "pallas_vmem"]),
        table_format=rng.choice(["auto", "dense"]),
    )
    find_all = rng.random() < 0.8
    use_handle = rng.random() < 0.3 and not cfg["auto_shard"]
    widen = random.Random(f"{seed}/widen")
    compressed = widen.random() < 1 / 3
    shards = widen.choice(SHARD_COUNTS)
    return dict(
        seed=seed, patterns=patterns, docs=docs, config=cfg,
        find_all=find_all, use_handle=use_handle, compressed=compressed,
        shards=shards if cfg["auto_shard"] else None,
    )


def run_config(case: dict) -> dict:
    """The ``ScanConfig`` fields a case runs with."""
    cfg = dict(case["config"])
    if case["compressed"]:
        cfg["table_format"] = "compressed"
    return cfg


def run_case(case: dict, device="cuda") -> dict:
    """Scan ``case`` on ``device``; returns ``{"ok": records}`` or
    ``{"skipped": reason}`` as the reference does (the whole message of a
    scan-time refusal, where the reference keeps 40 characters), and raises
    :class:`SoakMismatch` where the records differ from :func:`brute`."""
    from . import Matcher, ScanConfig
    from .parallel.mesh import local_shards

    patterns, docs = case["patterns"], case["docs"]
    find_all = case["find_all"]
    cfg = run_config(case)
    with local_shards(case["shards"]):
        try:
            m = Matcher(
                [{"id": i, "value": p} for i, p in enumerate(patterns)],
                ScanConfig(**cfg), device=device,
            )
        except ValueError:
            return {"skipped": BUILD_SKIP}
        try:
            tgt = m.device_corpus(docs) if case["use_handle"] else docs
            res = m.match_many(tgt, find_all=find_all)
        except ValueError as e:
            if any(w in str(e) for w in SKIP_WORDS):
                return {"skipped": str(e)}
            raise
    for doc, recs in zip(docs, res):
        want = brute(patterns, doc)
        if not find_all and want:
            first = want[0][0]
            want = [w for w in want if w[0] == first]
        got = [(r["pos"], r["keyIdx"]) for r in recs]
        if got != want:
            raise SoakMismatch(
                f"case seed {case['seed']}: config {cfg}, shards "
                f"{case['shards']}, find_all {find_all}, handle "
                f"{case['use_handle']}, document of {len(doc)} bytes: got "
                f"{got[:5]} (of {len(got)}), want {want[:5]} (of {len(want)})"
            )
    return {"ok": sum(map(len, res))}


@contextlib.contextmanager
def held_to_plain():
    """Every launch of a hand kernel, while the context is open, is held
    against the kernel's plain version on the same inputs
    (``ops/_build.observed``).  Yields ``{kernel: largest absolute
    difference}`` over those launches; an output of another shape or
    dtype raises :class:`SoakMismatch`.  The filters' outputs are
    candidate masks that the exact verify trims, so a kernel that keeps
    too much would not show in the records: this check is what holds the
    kernels themselves at the soak's shapes."""
    from .ops import _build

    err = dict.fromkeys(_build.KERNELS, 0)

    def hold(kernel, args, kw, got):
        want = kernel.plain(*args, **kw)
        pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        for i, (g, w) in enumerate(pairs):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise SoakMismatch(
                    f"{kernel.name} output {i}: {tuple(g.shape)} {g.dtype}, "
                    f"its plain version {tuple(w.shape)} {w.dtype}")
            if g.numel():
                d = int((g.long() - w.long()).abs().max().item())
                err[kernel.name] = max(err[kernel.name], d)

    with _build.observed(hold):
        yield err


def run_cases(seed: int, n: int, device="cuda", log=None) -> dict:
    """``n`` cases in this process, their seeds drawn from
    ``random.Random(seed)`` as the reference's child draws them.  Returns
    the cases, scans, skips by reason, each kernel's cases, launches and
    largest difference from its plain version (:func:`held_to_plain`, on
    the card; None on the CPU, where the wrapper is the plain version),
    and the device memory held after the first and the last case of the
    child (growth there is a leak) and at the peak.  A mismatch raises,
    and so does a kernel launch that differs from its plain version."""
    import torch

    from .ops._build import launch_counts

    rng = random.Random(seed)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    skips: dict = {}
    k_cases = dict.fromkeys(launch_counts(), 0)
    k_launches = dict(k_cases)
    mem = []
    ok = 0
    with (held_to_plain() if on_card else contextlib.nullcontext()) as err:
        for i in range(n):
            case_seed = rng.randrange(1 << 30)
            if log:
                log(f"CASE {case_seed}")
            before = launch_counts()
            r = run_case(draw_case(case_seed), device)
            if err and any(err.values()):
                raise SoakMismatch(
                    f"case seed {case_seed}: a hand kernel differs from its "
                    f"plain version on the same inputs (largest absolute "
                    f"difference by kernel: {err})")
            for name, count in launch_counts(before).items():
                k_cases[name] += count > 0
                k_launches[name] += count
            if "ok" in r:
                ok += 1
            else:
                skips[r["skipped"]] = skips.get(r["skipped"], 0) + 1
            if on_card and i in (0, n - 1):
                torch.cuda.synchronize()
                mem.append(torch.cuda.memory_allocated())
    return dict(
        cases=n, scans=ok, skips=skips,
        kernels={name: {"cases": c, "launches": k_launches[name],
                        "max_abs_err": err[name] if err else None}
                 for name, c in k_cases.items()},
        memory=dict(
            after_first=mem[0], after_last=mem[-1],
            peak=torch.cuda.max_memory_allocated(),
        ) if on_card else None,
    )


def merge(total: Optional[dict], part: dict) -> dict:
    """Two children's summaries as one (memory and differences from the
    plain versions: the largest of each)."""
    if total is None:
        return part
    out = dict(total)
    out["cases"] += part["cases"]
    out["scans"] += part["scans"]
    out["skips"] = dict(total["skips"])
    for k, v in part["skips"].items():
        out["skips"][k] = out["skips"].get(k, 0) + v
    out["kernels"] = {}
    for k, t in total["kernels"].items():
        p = part["kernels"][k]
        out["kernels"][k] = {
            "cases": t["cases"] + p["cases"],
            "launches": t["launches"] + p["launches"],
            "max_abs_err": None if t["max_abs_err"] is None
            else max(t["max_abs_err"], p["max_abs_err"]),
        }
    if total["memory"] is not None:
        out["memory"] = {k: max(total["memory"][k], part["memory"][k])
                         for k in total["memory"]}
    return out


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def run_child(seed: int, cases: int, device: str) -> dict:
    """One child process of ``cases`` cases at ``seed``; returns its
    summary, or exits 1 after printing the child's seed, its last case
    and the end of its output where it failed (a mismatch, an exception,
    a CUDA fault)."""
    cmd = [
        sys.executable, "-m", f"{__package__}.soak", "--child",
        "--seed", str(seed), "--cases", str(cases), "--device", device,
    ]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONHASHSEED=REPLAY_HASH_SEED)
    try:
        r = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                           text=True, timeout=CHILD_TIMEOUT_S)
        out, rc = r.stdout + r.stderr, r.returncode
    except subprocess.TimeoutExpired as e:
        # what the child wrote before it was killed (bytes or str)
        out = "".join(
            x.decode(errors="replace") if isinstance(x, bytes) else x
            for x in (e.stdout or "", e.stderr or ""))
        rc = f"timeout after {CHILD_TIMEOUT_S} s"
    lines = out.strip().splitlines()
    done = [ln for ln in lines if ln.startswith("CHILD OK ")]
    if rc != 0 or not done:
        started = [ln[5:] for ln in lines if ln.startswith("CASE ")]
        last = started[-1] if started else "none"
        print(f"SOAK FAILURE in child seed {seed} (exit {rc}), last case "
              f"{last}; replay: PYTHONHASHSEED={REPLAY_HASH_SEED} python -m "
              f"{__package__}.soak --replay {last} --device {device}",
              flush=True)
        print("\n".join(lines[-25:]), flush=True)
        sys.exit(1)
    return json.loads(done[-1][len("CHILD OK "):])


def report(s: dict) -> None:
    print(f"skips by reason: {json.dumps(s['skips'], sort_keys=True)}")
    for name, k in s["kernels"].items():
        held = ("" if k["max_abs_err"] is None else
                f", largest difference from its plain version "
                f"{k['max_abs_err']}")
        print(f"kernel {name}: launched in {k['cases']} cases, "
              f"{k['launches']} launches{held}")
    if s["memory"] is not None:
        print(f"device memory (bytes; largest over children): after the "
              f"first case {s['memory']['after_first']}, after the last "
              f"{s['memory']['after_last']}, peak {s['memory']['peak']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=int, default=600,
                    help="start no child after this many seconds")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cases", type=int, default=200,
                    help="cases per child process")
    ap.add_argument("--total", type=int, default=None,
                    help="stop after this many cases")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--replay", type=int, metavar="CASE_SEED", default=None,
                    help="run the case of this seed alone, in this process")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--artifact", default=None, help=(
        "write a JSON summary (cases, mismatches, seconds, skips, kernel "
        "launches and differences from the plain versions, card) on "
        "success"))
    args = ap.parse_args(argv)
    from .api import resolve_device

    device = str(resolve_device(args.device))  # raises with no card
    if args.replay is not None:
        case = draw_case(args.replay)
        print(f"case {args.replay}: {len(case['patterns'])} patterns, "
              f"{len(case['docs'])} documents, config {run_config(case)}, "
              f"shards {case['shards']}, find_all {case['find_all']}, "
              f"handle {case['use_handle']}", flush=True)
        on_card = device.startswith("cuda")
        with (held_to_plain() if on_card else contextlib.nullcontext()) as err:
            print(run_case(case, device), flush=True)
        if err is not None:
            print(f"largest difference from the plain versions: {err}",
                  flush=True)
            if any(err.values()):
                raise SoakMismatch(f"case seed {args.replay}: a hand kernel "
                                   f"differs from its plain version: {err}")
        return 0
    if args.child:
        s = run_cases(args.seed, args.cases, device,
                      log=lambda m: print(m, flush=True))
        print("CHILD OK " + json.dumps(s), flush=True)
        return 0
    card = card_line() if device.startswith("cuda") else None
    rng = random.Random(args.seed)
    t0 = time.time()
    total = None
    while time.time() - t0 < args.seconds:
        done = total["cases"] if total else 0
        if args.total is not None and done >= args.total:
            break
        n = args.cases if args.total is None else min(args.cases,
                                                      args.total - done)
        total = merge(total, run_child(rng.randrange(1 << 30), n, device))
        print(f"{total['cases']} cases in {time.time() - t0:.0f}s",
              flush=True)
    if total is None:
        raise SystemExit("no case ran: --seconds is 0")
    seconds = round(time.time() - t0)
    print(f"SOAK OK: {total['cases']} cases, 0 mismatches, {seconds} s, "
          f"{total['scans']} scans, on {card or device}")
    report(total)
    if args.artifact:
        with open(args.artifact, "w") as f:
            json.dump({
                "cases": total["cases"],
                "mismatches": 0,
                "seconds": seconds,
                "sweep": SWEEP,
                "seed": args.seed,
                "measured_at": time.strftime(
                    "%Y-%m-%dT%H:%M:%SZ", time.gmtime()
                ),
                "scans": total["scans"],
                "skips": total["skips"],
                "kernels": total["kernels"],
                "memory": total["memory"],
                "device": device,
                "card": card,
            }, f, indent=1)
        print(f"wrote {args.artifact}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
