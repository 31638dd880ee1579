"""Device time of the work launched in the G phase (span
``ieagan.train.g_phase``: G's forward and backward through D, G's update)
per traced step, ms."""
from benchmark.harness import spans


def read(run):
    return spans.read(run, "g_phase_ms.train")
