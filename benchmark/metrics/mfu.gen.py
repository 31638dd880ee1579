"""Model FLOPs of the traced generator calls over the traced window at the
published peak of the cell's precision, %."""
from benchmark.harness.readings import mfu


def read(run):
    return mfu(run, "generate")
