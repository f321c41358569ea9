"""Median wait in the batcher's queue plus the slot install [ms], VQA cells."""

from benchmark import readers


def read(run):
    return readers.queue_wait_ms_p50(run)
