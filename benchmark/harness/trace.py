"""The device trace of a traced window, and what the metrics read from it.

``Traced`` runs ``torch.profiler`` (host and CUDA activity) around the
traced window and reduces its Chrome trace to a ``Trace``: every device
event (kernel, copy, memset) in the window, the window's length, the time
in which something ran on the device, the device operations that took most
time, and the idle gaps named by the host operation that was running. The
window is the span ``bench.window`` that the traffic driver records around
its traced calls; each call is a span ``bench.call``. The program's own
spans in the same events are kept beside it, reduced by ``spans.reduce``,
for the readers of span metrics.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


@dataclass
class Trace:
    window_s: float
    busy_s: float
    calls: int
    kernels: list = field(default_factory=list)   # [(name, seconds)] of every kernel
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)
    spans: object = None            # spans.Spans of the same events

    def kernel_seconds(self, pattern: str) -> tuple[float, int]:
        """Total seconds and count of the kernels whose name matches."""
        rx = re.compile(pattern)
        hits = [s for n, s in self.kernels if rx.search(n)]
        return sum(hits), len(hits)


def _merge(intervals):
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def summarize(events: list, top: int = 10) -> Trace:
    """Reduce the ``X`` events of a Chrome trace (times in microseconds)."""
    spans = [e for e in events if e.get("name") == "bench.window"
             and e.get("cat") == "user_annotation"]
    if not spans:
        raise RuntimeError("the trace holds no bench.window span")
    lo = min(e["ts"] for e in spans)
    hi = max(e["ts"] + e["dur"] for e in spans)
    calls = sum(1 for e in events if e.get("name") == "bench.call"
                and e.get("cat") == "user_annotation" and lo <= e["ts"] < hi)
    device = [e for e in events if e.get("cat") in DEVICE_CATS
              and e["ts"] < hi and e["ts"] + e["dur"] > lo]
    clipped = [(max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in device]
    busy = _merge(clipped)
    busy_us = sum(b - a for a, b in busy)
    totals = {}
    for e, (a, b) in zip(device, clipped):
        totals[e["name"]] = totals.get(e["name"], 0.0) + (b - a) * 1e-6
    ops = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    kernels = [(e["name"], (b - a) * 1e-6) for e, (a, b) in zip(device, clipped)
               if e.get("cat") == "kernel"]
    # idle gaps, named by the innermost host operation running at their middle,
    # or, where the host ran no operation then (Python between operations),
    # by the operation it started next
    host = sorted((e for e in events if e.get("cat") in HOST_CATS
                   and not str(e.get("name", "")).startswith("bench.")),
                  key=lambda e: e["ts"])
    gaps, cursor = [], lo
    for a, b in busy + [[hi, hi]]:
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    by_name = {}
    starts = [e["ts"] for e in host]
    for a, b in gaps:
        mid = 0.5 * (a + b)
        name, best = None, None
        i = bisect.bisect_right(starts, mid)
        for e in host[max(0, i - 2000):i]:
            if e["ts"] <= mid < e["ts"] + e["dur"] and (best is None or e["dur"] < best):
                name, best = e["name"], e["dur"]
        if name is None:
            name = "between ops, before " + (host[i]["name"] if i < len(host) else "the end")
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    idle = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return Trace(window_s=(hi - lo) * 1e-6, busy_s=busy_us * 1e-6, calls=calls,
                 kernels=kernels, device_ops=[[n, s] for n, s in ops],
                 idle_gaps=[[n, s] for n, s in idle])


def chrome_events(prof) -> list:
    """The ``X`` events of a stopped profiler's Chrome trace, which goes to
    a temporary file, read and removed."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as fp:
            return [e for e in json.load(fp)["traceEvents"] if e.get("ph") == "X"]
    finally:
        os.unlink(path)


class Traced:
    """``with Traced() as t: ...`` profiles the block; ``t.trace`` is its
    ``Trace``, with the program's spans in ``t.trace.spans``."""

    def __enter__(self):
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        from benchmark.harness import spans     # which imports this module
        events = chrome_events(self.prof)
        self.trace = summarize(events)
        self.trace.spans = spans.reduce(events)
        return False
