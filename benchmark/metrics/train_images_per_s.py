"""Images trained in the window over its seconds (host clock)."""
from benchmark.harness.readings import rate


def read(run):
    return rate(run, "train", "images")
