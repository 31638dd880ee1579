"""Device time of the work launched in the D phase (span
``ieagan.train.d_phase``: G's no-grad forward, DiffAugment, D's passes,
losses, backward and D's update) per traced step, ms."""
from benchmark.harness import spans


def read(run):
    return spans.read(run, "d_phase_ms.train")
