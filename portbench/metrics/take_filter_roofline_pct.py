"""The flat take filter's share of its roofline: the least time its work
needs on the card (``bounds.sampled_filter_work``, from each call's
shapes and plan: corpus rows, row length, q, stride, the positional
bloom's bytes, 6 operations a probe) over the device time of every
operation the profiler links to the benchmark's span around
``filter_hits_sampled``, in the profiled slice.  The work is a floor,
so the share is too."""

import inspect

from portbench.bounds import sampled_filter_work

SPANS = {
    "take_filter": [
        "php_aho_corasick_tpu_torch.ops.filter_torch:filter_hits_sampled",
    ],
}


def _work(fn, args, kwargs):
    a = inspect.signature(fn).bind(*args, **kwargs).arguments
    rows, row_len = a["chunks"].shape
    return sampled_filter_work(rows, row_len, a["q"], a["stride"],
                               a["words"].numel() * 4, 6)


NOTES = {"take_filter": _work}


def read(run):
    s = (run.profile or {}).get("spans", {}).get("take_filter")
    work = run.spans.notes("take_filter", "slice")
    if not s or not work or s["device_us"] <= 0:
        return None
    least_us = sum(w["seconds"] for w in work) * 1e6
    return 100.0 * least_us / s["device_us"]
