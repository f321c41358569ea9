"""Share of the traced window with no device operation [%], VQA cells."""

from benchmark import readers


def read(run):
    return readers.idle_share(run)
