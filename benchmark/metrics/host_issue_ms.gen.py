"""Host time of the program's generator call (span ``ieagan.gen.call``: the
draw, G's forward and the postprocess as the host issues them) per traced
call, ms."""
from benchmark.harness import spans


def read(run):
    return spans.read(run, "host_issue_ms.gen")
