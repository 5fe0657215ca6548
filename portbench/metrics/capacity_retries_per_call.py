"""Capacity retries (``Matcher.stats.capacity_retries``: a device chain
re-run because a learned capacity overflowed) in the window, over its
calls."""


def read(run):
    return run.retries / run.n_calls
