"""Share of the eval spectral-norm passes in the traced generator calls that
returned the kept W/σ (span ``ieagan.sn.cached``) over those and the power
iterations (span ``ieagan.sn``)."""
from benchmark.harness import spans


def read(run):
    return spans.read(run, "sn_hit_share.gen")
