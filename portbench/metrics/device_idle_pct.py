"""Share of the profiled slice in which no kernel, copy or set ran on the
card (the mean over the cards a run uses)."""


def read(run):
    p = run.profile
    if p is None or not p["busy_us"]:
        return None
    busy = sum(p["busy_us"].values()) / len(p["busy_us"])
    return 100.0 * (1.0 - busy / p["window_us"])
