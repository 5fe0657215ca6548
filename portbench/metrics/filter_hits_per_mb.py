"""Filter survivors (the windows the records verify walks) a megabyte
scanned: the program's counter ``ScanStats.filter_hits`` gained in the
window over the window's haystack megabytes (1 MB = 1e6 bytes).  The
counter is noted by a wrapper on ``Program.retries``, which the harness
calls once just before the window's first call and once just after its
last, as ``portbench/program.py`` notes ``host_waits``.  A program
without the counter gives nothing to read."""


def _filter_hits(fn, args, kwargs):
    m = getattr(args[0], "m", None) if args else None
    return getattr(getattr(m, "stats", None), "filter_hits", None)


SPANS = {"program.filter_hits": ["portbench.system:Program.retries"]}
NOTES = {"program.filter_hits": _filter_hits}


def read(run):
    notes = run.spans.notes("program.filter_hits", "window")
    mb = sum(b for _, _, b in run.calls) / 1e6
    if len(notes) != 2 or mb <= 0:
        return None
    return (notes[1] - notes[0]) / mb
