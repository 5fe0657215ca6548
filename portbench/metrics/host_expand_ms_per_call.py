"""Host milliseconds a call inside the expansion of device records into
``(document, end, pattern)`` arrays (the records path's
``emit_records_arrays``, the scan paths' ``expand_matches_arrays``), over
the window's calls outside the profiled slice."""

SPANS = {
    "expand": [
        "php_aho_corasick_tpu_torch.models.cascade:CascadeModel.emit_records_arrays",
        "php_aho_corasick_tpu_torch.ops.matches:expand_matches_arrays",
        "php_aho_corasick_tpu_torch.api:expand_matches_arrays",
    ],
}


def read(run):
    if not run.spans.count("expand") or not run.n_calls:
        return None
    return run.spans.host_seconds({"expand"}) * 1e3 / run.n_calls
