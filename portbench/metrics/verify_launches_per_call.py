"""Device operations the profiler links to the records verify (the
benchmark's span around each of its entry points), over the slice's
calls."""

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
    return s["ops"] / run.profile["calls"]
