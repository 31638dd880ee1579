"""Set-up: process start to the first timed call, s (host clock)."""


def read(run):
    return run.setup_s or None
