"""90th percentile of the window's generator calls, each from its start to
the synchronize that ends it, ms (host clock)."""
from benchmark.harness.readings import call_percentile_ms


def read(run):
    return call_percentile_ms(run, "generate", 0.90)
