"""Host time of the train step (span ``ieagan.train.step``) less the wait for
the card at its end (span ``ieagan.train.wait``) per traced step, ms."""
from benchmark.harness import spans


def read(run):
    return spans.read(run, "host_issue_ms.train")
