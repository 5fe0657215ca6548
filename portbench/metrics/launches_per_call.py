"""Device operations (kernels, copies, sets) in the profiled slice, over
its calls: the public API's dispatch, one launch at a time from the host.

The spans below only label the host's idle gaps in the breakdown."""

SPANS = {
    "api.dispatch": [
        "php_aho_corasick_tpu_torch.api:Matcher._records_batch_dispatch",
        "php_aho_corasick_tpu_torch.api:Matcher._records_batch_sharded_dispatch",
    ],
    "api.finish": [
        "php_aho_corasick_tpu_torch.api:Matcher._records_batch_finish",
        "php_aho_corasick_tpu_torch.api:Matcher._records_batch_sharded_finish",
    ],
}


def read(run):
    if run.profile is None or not run.profile["device_ops"]:
        return None
    return run.profile["device_ops"] / run.profile["calls"]
