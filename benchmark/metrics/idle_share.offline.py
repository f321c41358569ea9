"""Share of the traced window with no device operation [%], offline cells."""

from benchmark import readers


def read(run):
    return readers.idle_share(run)
