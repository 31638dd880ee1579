"""Device kernels in the traced window per generator call."""
from benchmark.harness.readings import launches_per_call


def read(run):
    return launches_per_call(run, "generate")
