"""Model operations in the traced window over the card's bf16 peak [%], VQA
cells."""

from benchmark import readers


def read(run):
    return readers.mfu(run)
