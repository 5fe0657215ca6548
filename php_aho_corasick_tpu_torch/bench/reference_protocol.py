"""The PHP extension's own benchmark protocol: the JAX package's
``benchmarks/benchmark_reference.py`` on the port.

``--samples`` samples; each draws 2048 needles (16 symbols over
``abcdef``) and 256 haystacks of 8192 symbols (2 MiB) from one
``random.Random(20260817)`` stream, and times a naive per-needle
substring search (over ``--naive-needles`` of the needles, scaled to all
of them) against Aho-Corasick with the automaton's build inside the
timing: ``Matcher(...)`` + ``match_many``, ending in its host records,
by CUDA events on the card.  The PHP extension took 13.061 s naive and
0.174 s Aho-Corasick a pass on its author's machine (74.9x).

    python -m php_aho_corasick_tpu_torch.bench.reference_protocol
        [--samples 10] [--naive-needles 128] [--device cpu]
        [--artifact PATH]
"""

from __future__ import annotations

import random
import sys
import time

from .. import Matcher, ScanConfig
from ..api import resolve_device
from . import _timing

SEED = 20260817  # the draws' random.Random seed
REFERENCE = ("PHP, author's machine: naive 13.061 s, ac 0.174 s, 74.9x "
             "(README.md:182-187)")


def gen(rng: random.Random, n: int, alphabet: bytes = b"abcdef") -> bytes:
    return bytes(rng.choice(alphabet) for _ in range(n))


def draw_sample(rng: random.Random, needles: int, needle_len: int,
                haystacks: int, haystack_len: int):
    """One sample's ``(needles, haystacks)`` from ``rng``, in the
    reference's order; the needles as its ``list(set)``."""
    ns = list({gen(rng, needle_len) for _ in range(needles)})
    hs = [gen(rng, haystack_len) for _ in range(haystacks)]
    return ns, hs


def naive_count(needles, haystacks) -> int:
    """strpos-style occurrences of each needle in each haystack."""
    found = 0
    for h in haystacks:
        for p in needles:
            ofs = h.find(p)
            while ofs != -1:
                found += 1
                ofs = h.find(p, ofs + 1)
    return found


def run(samples: int = 10, needles: int = 2048, needle_len: int = 16,
        haystacks: int = 256, haystack_len: int = 8192,
        naive_needles: int = 128, device=None) -> dict:
    """The protocol's record on ``device`` (default: the CUDA card; raises
    with none)."""
    device = resolve_device(device)
    kernels = _timing.Kernels(device)
    rng = random.Random(SEED)
    drawn = [draw_sample(rng, needles, needle_len, haystacks, haystack_len)
             for _ in range(samples)]

    def ac(ns, hs):
        m = Matcher([{"id": i, "value": p} for i, p in enumerate(ns)],
                    ScanConfig(backend="device"), device=device)
        return sum(map(len, m.match_many(hs)))

    kernels.hold(lambda: ac(*drawn[0]))
    rows = []
    for s, (ns, hs) in enumerate(drawn):
        t0 = time.perf_counter()
        naive_count(ns[:naive_needles], hs)
        scale = needles / max(naive_needles, 1)
        naive_s = (time.perf_counter() - t0) * scale
        ms, n = _timing.call_ms(device, lambda: ac(ns, hs))
        rows.append({"naive_s": naive_s, "ac_s": ms / 1e3, "matches": n})
        print(f"sample {s}: naive(est)={naive_s:.3f}s "
              f"ac={ms / 1e3:.3f}s matches={n}", flush=True)

    mib = haystacks * haystack_len / 2**20
    avg_naive = sum(r["naive_s"] for r in rows) / len(rows)
    avg_ac = sum(r["ac_s"] for r in rows) / len(rows)
    return {
        "samples": rows,
        "corpus_mib": mib,
        "avg_naive_s": avg_naive,
        "avg_ac_s": avg_ac,
        "ac_gibps": mib / 1024 / avg_ac,
        "speedup": avg_naive / avg_ac,
        "matches": sum(r["matches"] for r in rows),
        "reference": REFERENCE,
        "hash_seed": _timing.hash_seed(),
        "device": _timing.card_line(device),
        "kernels": kernels.record(),
    }


def main(argv=None) -> int:
    ap = _timing.parser(__doc__.split("\n\n")[0])
    ap.add_argument("--samples", type=int, default=10)
    ap.add_argument("--needles", type=int, default=2048)
    ap.add_argument("--needle-len", type=int, default=16)
    ap.add_argument("--haystacks", type=int, default=256)
    ap.add_argument("--haystack-len", type=int, default=8192)
    ap.add_argument(
        "--naive-needles", type=int, default=128,
        help="needles of the naive pass (all 2048 take minutes in Python, "
             "like the reference's 13 s a pass in PHP); the time is scaled "
             "to all of them")
    a = ap.parse_args(argv)
    _timing.finish(run(a.samples, a.needles, a.needle_len, a.haystacks,
                       a.haystack_len, a.naive_needles, a.device),
                   a.artifact)
    return 0


if __name__ == "__main__":
    sys.exit(main())
