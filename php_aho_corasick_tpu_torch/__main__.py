"""Command-line interface.

    python -m php_aho_corasick_tpu_torch scan -p patterns.txt -i corpus.bin
    python -m php_aho_corasick_tpu_torch replace -p patterns.txt -r repl.tsv -i in -o out
    python -m php_aho_corasick_tpu_torch build -p patterns.txt -o automaton.npz
    python -m php_aho_corasick_tpu_torch info -m automaton.npz

Pattern files: one pattern per line (UTF-8; lines are byte patterns).
Replacement files: TAB-separated ``pattern<TAB>replacement`` lines.
Every command runs on CUDA unless ``--device cpu`` is given.  Saved
automata are the JAX package's format (``utils/serialization.py``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _read_patterns(path: str):
    with open(path, "rb") as f:
        return [ln for ln in f.read().split(b"\n") if ln]


def _build_matcher(args):
    from . import Matcher, ScanConfig

    cfg = ScanConfig(backend=args.backend, engine=args.engine)
    pats = _read_patterns(args.patterns)
    m = Matcher([{"id": i, "value": p} for i, p in enumerate(pats)], cfg,
                device=args.device)
    m.finalize()
    return m, pats


def cmd_scan(args) -> int:
    m, pats = _build_matcher(args)
    with open(args.input, "rb") as f:
        data = f.read()
    t0 = time.time()
    recs = m.match(data)
    dt = time.time() - t0
    for r in recs:
        print(
            json.dumps(
                {
                    "pos": r["pos"],
                    "start": r["start_postion"],
                    "pattern": r["value"].decode("utf-8", "backslashreplace"),
                }
            )
        )
    print(
        f"# {len(recs)} matches in {dt:.3f}s "
        f"({len(data) / max(dt, 1e-9) / 1e6:.1f} MB/s), "
        f"engine={m.stats.last_engine or 'scalar'}",
        file=sys.stderr,
    )
    return 0


def cmd_replace(args) -> int:
    m, _ = _build_matcher(args)
    rmap = {}
    with open(args.replacements, "rb") as f:
        for ln in f.read().split(b"\n"):
            if b"\t" in ln:
                k, v = ln.split(b"\t", 1)
                rmap[k] = v
    with open(args.input, "rb") as f:
        data = f.read()
    out = m.replace(data, rmap, mode=args.mode)
    with open(args.output, "wb") as f:
        f.write(out)
    print(f"# wrote {len(out)} bytes to {args.output}", file=sys.stderr)
    return 0


def cmd_build(args) -> int:
    from .utils.serialization import save_matcher

    t0 = time.time()
    m, pats = _build_matcher(args)
    save_matcher(m, args.output)
    auto = m.automaton
    print(
        f"# {len(pats)} patterns -> {auto.n_states} states "
        f"({auto.table_bytes / 2**20:.1f} MiB) in {time.time() - t0:.2f}s "
        f"-> {args.output}",
        file=sys.stderr,
    )
    return 0


def cmd_info(args) -> int:
    from .utils.serialization import load_matcher

    m = load_matcher(args.matcher, device=args.device)
    print(m.describe(), end="")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="php_aho_corasick_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def device(p):
        p.add_argument("--device", default="cuda",
                       help="torch device to run on (default: cuda)")

    def common(p):
        p.add_argument("-p", "--patterns", required=True)
        p.add_argument("--backend", default="auto",
                       choices=["auto", "device", "host"])
        p.add_argument("--engine", default="auto",
                       choices=["auto", "dfa", "kgram", "cascade", "tile"])
        device(p)

    p = sub.add_parser("scan", help="scan a file, print matches as JSONL")
    common(p)
    p.add_argument("-i", "--input", required=True)
    p.set_defaults(fn=cmd_scan)

    p = sub.add_parser("replace", help="search-and-replace a file")
    common(p)
    p.add_argument("-r", "--replacements", required=True)
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--mode", default="normal", choices=["normal", "lazy"])
    p.set_defaults(fn=cmd_replace)

    p = sub.add_parser("build", help="compile patterns, save automaton")
    common(p)
    p.add_argument("-o", "--output", required=True)
    p.set_defaults(fn=cmd_build)

    p = sub.add_parser("info", help="describe a saved automaton")
    p.add_argument("-m", "--matcher", required=True)
    device(p)
    p.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
