"""Host seconds inside the cascade's planner (``plan_cascade``)."""

SPANS = {"plan": ["php_aho_corasick_tpu_torch.models.cascade:plan_cascade"]}


def read(run):
    if not run.spans.count("plan", "setup"):
        return None
    return run.spans.host_seconds({"plan"}, "setup")
