"""The program's spans in a traced window, and the per-layer readings they
give.

The port names its layers with ``torch.profiler.record_function`` spans
(``ieagan_torch/core/spans.py``, every name ``ieagan.<layer>...``). This
module reduces the ``X`` events of a Chrome trace (times in microseconds),
the same events ``trace.Traced`` loads, to a ``Spans``: per span name, its
count, host time, self time, and the device time and launches of the work
launched under it.

- A device event (kernel, copy, memset) is matched to its launch, the
  ``cuda_runtime`` or ``cuda_driver`` event with the same
  ``args.correlation``.
- A device event counts for span name X if any span named X, on any
  thread, holds the launch's start: the autograd engine's thread launches
  the backward while the main thread sits in ``*_backward``.
- Host time of X is the sum of its spans' durations, clipped to the
  window; self time takes off the part its child program spans on the same
  thread cover.
- Device times are clipped to the window, as ``trace.summarize`` clips them.
- Readings are per call (``bench.call``).

A trace of a program without spans gives no program span, and every
reading None.

    python3 -m benchmark.harness.spans <chrome trace> [--per NAME]

prints the per-span table of a Chrome trace: the benchmark's (window
``bench.window``, calls ``bench.call``) or the training driver's
``trace_dir`` trace (no window, so the whole trace; ``--per
ieagan.train.step``).
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
from dataclasses import dataclass, field

from benchmark.harness.trace import DEVICE_CATS, _merge

PREFIX = "ieagan."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class Span:
    """One span name's totals over the window."""
    count: int = 0
    host_s: float = 0.0
    self_s: float = 0.0
    device_s: float = 0.0
    launches: int = 0               # kernels launched under it


@dataclass
class Spans:
    calls: int
    window_s: float
    device_s: float                 # every device event in the window
    kernels: int
    by_name: dict = field(default_factory=dict)     # name -> Span
    # [(seconds, is kernel, the span names holding its launch)] of each device event
    device: list = field(default_factory=list)

    def under(self, match) -> tuple[float, int]:
        """Device seconds and kernels launched under any span whose name
        ``match(name)`` accepts, each device event counted once."""
        secs, n = 0.0, 0
        for s, is_kernel, names in self.device:
            if any(match(x) for x in names):
                secs += s
                n += is_kernel
        return secs, n

    def host_ms(self, name: str):
        """Host ms a call in spans ``name``, or None where none ran."""
        sp = self.by_name.get(name)
        return None if sp is None or not self.calls else 1e3 * sp.host_s / self.calls

    def device_ms(self, match):
        """Device ms a call launched under spans that ``match`` accepts, or
        None where no such span ran."""
        if not self.calls or not any(match(x) for x in self.by_name):
            return None
        return 1e3 * self.under(match)[0] / self.calls


def _window(events):
    wins = [e for e in events if e.get("name") == "bench.window"
            and e.get("cat") == "user_annotation"]
    if not wins:
        wins = [e for e in events if "ts" in e and "dur" in e]
    return min(e["ts"] for e in wins), max(e["ts"] + e["dur"] for e in wins)


def reduce(events: list, per: str = "bench.call") -> Spans:
    """Reduce a Chrome trace's ``X`` events; ``per`` names the span that
    counts calls."""
    lo, hi = _window(events)
    calls = sum(1 for e in events if e.get("name") == per
                and e.get("cat") == "user_annotation" and lo <= e["ts"] < hi)
    program = [e for e in events if e.get("cat") == "user_annotation"
               and str(e.get("name", "")).startswith(PREFIX)]
    by_name = {}
    # host and self time, thread by thread: spans on one thread nest
    threads = {}
    for e in program:
        threads.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    clip = lambda a, b: max(0.0, min(b, hi) - max(a, lo))
    for on_thread in threads.values():
        on_thread.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []          # [(end, Span)] of the spans open at e's start
        for e in on_thread:
            while stack and stack[-1][0] <= e["ts"]:
                stack.pop()
            own = clip(e["ts"], e["ts"] + e["dur"]) * 1e-6
            sp = by_name.setdefault(e["name"], Span())
            if e["ts"] < hi and e["ts"] + e["dur"] > lo:
                sp.count += 1
            sp.host_s += own
            sp.self_s += own
            if stack:
                stack[-1][1].self_s -= own
            stack.append((e["ts"] + e["dur"], sp))
    # which names hold each launch
    intervals = {}
    for e in program:
        intervals.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    merged = {n: _merge(iv) for n, iv in intervals.items()}
    starts = {n: [a for a, _ in iv] for n, iv in merged.items()}

    def holding(t):
        out = []
        for n, iv in merged.items():
            i = bisect.bisect_right(starts[n], t) - 1
            if i >= 0 and iv[i][0] <= t < iv[i][1]:
                out.append(n)
        return frozenset(out)

    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    device, total, kernels = [], 0.0, 0
    for e in events:
        if e.get("cat") not in DEVICE_CATS or not (e["ts"] < hi and e["ts"] + e["dur"] > lo):
            continue
        s = clip(e["ts"], e["ts"] + e["dur"]) * 1e-6
        is_kernel = e.get("cat") == "kernel"
        total += s
        kernels += is_kernel
        t = launch.get(e.get("args", {}).get("correlation"))
        names = holding(t) if t is not None else frozenset()
        device.append((s, is_kernel, names))
        for n in names:
            by_name[n].device_s += s
            by_name[n].launches += is_kernel
    return Spans(calls=calls, window_s=(hi - lo) * 1e-6, device_s=total, kernels=kernels,
                 by_name=by_name, device=device)


def _attn(name):
    return name == "ieagan.attn" or name.startswith("ieagan.attn.")


def _host_issue(s: Spans):
    step, wait = s.host_ms("ieagan.train.step"), s.host_ms("ieagan.train.wait")
    return None if step is None or wait is None else step - wait


def _sn_hit_share(s: Spans):
    """Eval SN passes that returned the kept W/σ (``ieagan.sn.cached``)
    over those and the power iterations (``ieagan.sn``)."""
    hits, misses = (s.by_name[n].count if n in s.by_name else 0
                    for n in ("ieagan.sn.cached", "ieagan.sn"))
    return hits / (hits + misses) if hits + misses else None


# the per-layer readings: metric -> (family of the calls, reading of a
# Spans); a time is ms a call
READINGS = {
    "host_issue_ms.gen": ("generate", lambda s: s.host_ms("ieagan.gen.call")),
    "sn_hit_share.gen": ("generate", _sn_hit_share),
    "sn_ms.gen": ("generate", lambda s: s.host_ms("ieagan.sn")),
    "attn_ms.gen": ("generate", lambda s: s.device_ms(_attn)),
    "host_issue_ms.train": ("train", _host_issue),
    "d_phase_ms.train": ("train", lambda s: s.device_ms(lambda n: n == "ieagan.train.d_phase")),
    "g_phase_ms.train": ("train", lambda s: s.device_ms(lambda n: n == "ieagan.train.g_phase")),
    "update_ms.train": ("train", lambda s: s.device_ms(
        lambda n: n in ("ieagan.train.update", "ieagan.train.ema"))),
    "sn_ms.train": ("train", lambda s: s.host_ms("ieagan.sn")),
    "attn_ms.train": ("train", lambda s: s.device_ms(_attn)),
}


def read(run, metric: str):
    """``metric``'s reading of ``run`` (``harness.run_state.Run``), or None
    for calls of the other family (``run.family``), an untraced run, or a
    trace without the spans it reads (``run.trace.spans``, a ``Spans``)."""
    family, reading = READINGS[metric]
    s = getattr(run.trace, "spans", None)
    if run.family != family or s is None:
        return None
    return reading(s)


def table(s: Spans, family: str | None = None) -> list:
    """The per-span table's lines: per call, each span's count, host ms,
    self ms, device ms and kernels launched under it, and its shares of
    the window's device time and kernels; then the readings of ``family``,
    by default the family of the spans found (a train step's, or a generator
    call's)."""
    per = max(s.calls, 1)
    lines = [f"spans: {s.calls} calls in {s.window_s:.6f} s; a call: device "
             f"{1e3 * s.device_s / per:.6f} ms, {s.kernels / per:.1f} kernels",
             f"{'span':<28}{'count':>9}{'host ms':>13}{'self ms':>13}{'device ms':>13}"
             f"{'kernels':>10}{'device %':>10}{'kernels %':>10}"]
    for name in sorted(s.by_name):
        sp = s.by_name[name]
        lines.append(
            f"{name:<28}{sp.count / per:>9.2f}{1e3 * sp.host_s / per:>13.6f}"
            f"{1e3 * sp.self_s / per:>13.6f}{1e3 * sp.device_s / per:>13.6f}"
            f"{sp.launches / per:>10.1f}{100 * sp.device_s / max(s.device_s, 1e-30):>10.3f}"
            f"{100 * sp.launches / max(s.kernels, 1):>10.3f}")
    if family is None:
        family = ("train" if "ieagan.train.step" in s.by_name
                  else "generate" if "ieagan.gen.call" in s.by_name else None)
    for metric, (f, reading) in READINGS.items():
        value = reading(s) if f == family else None
        if value is not None:
            lines.append(f"{metric} {value:.6f}" + (" ms" if "_ms." in metric else ""))
    return lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="The per-span table of a Chrome trace.")
    parser.add_argument("trace")
    parser.add_argument("--per", default="bench.call",
                        help="the span that counts calls (default bench.call)")
    args = parser.parse_args(argv)
    with open(args.trace, encoding="utf-8") as fp:
        events = [e for e in json.load(fp)["traceEvents"] if e.get("ph") == "X"]
    print("\n".join(table(reduce(events, args.per))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
