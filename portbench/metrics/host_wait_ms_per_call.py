"""Host milliseconds a call inside the program's own ``wait`` spans (each
point where the host blocks on the card: a sync, or a fetch of counts or
records), over the window's calls.  Read from the program's recorder
(``portbench/program.py``)."""

from portbench import program

program.record()


def read(run):
    return program.window_ms_per_call(run, {"wait"})
