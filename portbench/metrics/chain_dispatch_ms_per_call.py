"""Host milliseconds a call inside the program's own ``chain`` spans
(``CascadeModel.launch_device_records``: the host enqueuing one filter
and records-verify chain, one a shard on a mesh), over the window's
calls; nested or overlapping spans counted once.  Read from the
program's recorder (``portbench/program.py``)."""

from portbench import program

program.record()


def read(run):
    return program.window_ms_per_call(run, {"chain"})
