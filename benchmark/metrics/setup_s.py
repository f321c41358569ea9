"""Set-up seconds: process start to the first request sent."""


def read(run):
    return run.setup_s
