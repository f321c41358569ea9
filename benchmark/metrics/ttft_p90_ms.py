"""Time to first token, 90th percentile over the requests due in the window
[ms]."""

from benchmark import readers


def read(run):
    return readers.ttft_p90_ms(run)
