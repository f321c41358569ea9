"""K5 (decode_blocked_fwd) least time over its device time [%], offline
cells."""

from benchmark import readers


def read(run):
    return readers.k5_roofline(run)
