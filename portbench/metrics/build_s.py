"""Host seconds to construct the matcher from the needles and finalize
it (the builder and the table), the plan excluded."""


def read(run):
    return run.timings.get("build_s")
