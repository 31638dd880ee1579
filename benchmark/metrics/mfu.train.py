"""Model FLOPs of the traced train steps (no recomputation) over the traced
window at the published peak of the cell's precision, %."""
from benchmark.harness.readings import mfu


def read(run):
    return mfu(run, "train")
