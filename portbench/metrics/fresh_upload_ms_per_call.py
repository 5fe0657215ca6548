"""Host milliseconds a call inside the fresh path's pack and upload
(``Matcher._pack``, ``Matcher._upload``), over the window's calls outside
the profiled slice."""

SPANS = {
    "fresh.pack": ["php_aho_corasick_tpu_torch.api:Matcher._pack"],
    "fresh.upload": ["php_aho_corasick_tpu_torch.api:Matcher._upload"],
}


def read(run):
    names = {"fresh.pack", "fresh.upload"}
    if not any(run.spans.count(n) for n in names) or not run.n_calls:
        return None
    return run.spans.host_seconds(names) * 1e3 / run.n_calls
