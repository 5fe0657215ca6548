"""Haystack bytes of every call completed in the window over the window's
seconds (1 GB = 1e9 bytes); each call ends with its records in host
memory.  Host clock."""


def read(run):
    return sum(b for _, _, b in run.calls) / run.window_s / 1e9
