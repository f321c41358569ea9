"""Dispatch wall per decode step [ms], offline cells."""

from benchmark import readers


def read(run):
    return readers.decode_step_ms(run)
