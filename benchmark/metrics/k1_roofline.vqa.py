"""K1 (flash_varlen_fwd) least time over its device time [%], VQA cells."""

from benchmark import readers


def read(run):
    return readers.k1_roofline(run)
