"""Device microseconds of the records verify a call: the device time of
every operation the profiler links to the benchmark's span around the
verify's entry points (the window walk against the table, wherever it
lives), in the profiled slice, over the slice's calls."""

SPANS = {
    "verify": [
        "php_aho_corasick_tpu_torch.ops.filter_torch:verify_windows_records",
        "php_aho_corasick_tpu_torch.ops.filter_torch:verify_windows_records2",
        "php_aho_corasick_tpu_torch.ops.filter_torch:verify_windows_records_compressed",
    ],
}


def read(run):
    s = (run.profile or {}).get("spans", {}).get("verify")
    if not s or not s["ops"]:
        return None
    return s["device_us"] / run.profile["calls"]
