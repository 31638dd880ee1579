"""Host time of the spectral norm's power iterations (spans ``ieagan.sn``)
per traced train step, ms."""
from benchmark.harness import spans


def read(run):
    return spans.read(run, "sn_ms.train")
