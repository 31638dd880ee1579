"""Named spans of the port's layers in a ``torch.profiler`` trace.

``with span("ieagan.<layer>..."):`` is ``torch.profiler.record_function``
while a torch profiler runs, so the span lands in the profiler's Chrome
trace on the kernels' clock, and a shared do-nothing context otherwise: a
``record_function`` costs ~12 µs on a CPU even with no profiler running,
the flag check ~0.3 µs. The profiler keeps and writes the spans; nothing
here stores them.
"""

from __future__ import annotations

import contextlib

from torch.autograd import profiler
from torch.autograd.profiler import record_function

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` while a torch profiler runs."""
    if profiler._is_profiler_enabled:
        return record_function(name)
    return _OFF
