"""Events completed in the window over its seconds (host clock)."""
from benchmark.harness.readings import rate


def read(run):
    return rate(run, "generate", "events")
