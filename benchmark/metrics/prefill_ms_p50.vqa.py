"""Median prefill wall (host prep to first token) [ms], VQA cells."""

from benchmark import readers


def read(run):
    return readers.prefill_ms_p50(run)
