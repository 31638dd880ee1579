"""Device time of the work launched in the optimiser updates and the EMA
(spans ``ieagan.train.update``, ``ieagan.train.ema``) per traced step, ms."""
from benchmark.harness import spans


def read(run):
    return spans.read(run, "update_ms.train")
