"""The sampled filter stage's share of its roofline: the least time its
work needs on the card (``bounds.sampled_filter_work``, from each filter
call's shapes and plan: corpus rows, row length, q, stride, bloom bytes)
over the device time of every operation the profiler links to the
benchmark's span around the stage's entry point, in the profiled slice.
The work is a floor (bytes bind it at these shapes), so the share is
too."""

import inspect

from portbench.bounds import sampled_filter_work

SPANS = {
    "filter": [
        "php_aho_corasick_tpu_torch.ops.filter_torch:filter_hits_sampled_vmem",
        "php_aho_corasick_tpu_torch.ops.filter_torch:filter_hits_sampled_grouped",
    ],
}


def _work(fn, args, kwargs):
    a = inspect.signature(fn).bind(*args, **kwargs).arguments
    rows, row_len = a["chunks"].shape
    if "table" in a:  # banked bloom words, 12 operations a probe
        bloom, probe_ops = a["table"].numel() * 4, 12
    else:  # positional bloom bits, 6 operations a probe
        bloom = a["words"].numel() * 4
        if a.get("words2") is not None:
            bloom += a["words2"].numel() * 4
        probe_ops = 6
    return sampled_filter_work(rows, row_len, a["q"], a["stride"], bloom,
                               probe_ops)


NOTES = {"filter": _work}


def read(run):
    s = (run.profile or {}).get("spans", {}).get("filter")
    work = run.spans.notes("filter", "slice")
    if not s or not work or s["device_us"] <= 0:
        return None
    least_us = sum(w["seconds"] for w in work) * 1e6
    return 100.0 * least_us / s["device_us"]
