"""The 95th percentile (nearest rank) over every call of the window of
its host-clock time, from the call's start to its return with records."""


def read(run):
    ms = sorted((t1 - t0) * 1e3 for t0, t1, _ in run.calls)
    return ms[max(0, -(-95 * len(ms) // 100) - 1)]
