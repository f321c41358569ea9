"""Output tokens handed to clients inside the window, per second."""

from benchmark import readers


def read(run):
    return readers.output_tok_s(run)
