"""Host seconds of set-up inside the program's own ``pack`` and
``upload`` spans (``Matcher._pack``, ``Matcher._upload``: the resident
corpus packed into rows and copied to the card, once a handle); nested
spans counted once.  Read from the program's recorder
(``portbench/program.py``)."""

from portbench import program

program.record()


def read(run):
    return program.setup_seconds(run, {"pack", "upload"})
