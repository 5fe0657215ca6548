"""Times a call's host blocks on the card: the program's counter
``ScanStats.host_waits`` gained in the window, over its calls (noted at
the window's bounds, ``portbench/program.py``).  A CUDA graph of a chain
cannot cross one."""

from portbench import program

SPANS = program.COUNTER_SPANS
NOTES = program.COUNTER_NOTES


def read(run):
    n = program.window_count(run)
    if n is None or not run.n_calls:
        return None
    return n / run.n_calls
