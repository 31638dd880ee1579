"""What the metric readers under ``metrics/`` compute, each reader naming
one of these for a family of calls (``run.family``: ``"generate"``, a
generator call; ``"train"``, a train step), whichever traffic driver ran
them. A reader returns None where its run holds nothing to read (a call of
another family or unit, an untraced run, no kernel of the kind in the
trace)."""

from __future__ import annotations

import math

from benchmark.harness import manifest
from benchmark.work import attention


def rate(run, family: str, unit: str):
    """Units (``run.unit``: events or images) completed in the window over
    its seconds."""
    if run.family != family or run.unit != unit or not run.window_s:
        return None
    return run.calls * run.units_per_call / run.window_s


def call_percentile_ms(run, family: str, q: float):
    """The ``q`` percentile (nearest rank) of the window's call times, ms."""
    if run.family != family or not run.call_seconds:
        return None
    times = sorted(run.call_seconds)
    return 1e3 * times[max(0, math.ceil(q * len(times)) - 1)]


def launches_per_call(run, family: str):
    t = run.trace
    if run.family != family or t is None or not t.calls:
        return None
    return len(t.kernels) / t.calls


def device_idle(run, family: str):
    t = run.trace
    if run.family != family or t is None or not t.window_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def _precision(run):
    return manifest.peaks(run.cell.root)["precisions"][run.cell.workload["precision"]]


def mfu(run, family: str):
    """Model FLOPs of the traced calls over the traced window at the
    published peak of the cell's precision, %."""
    t = run.trace
    if run.family != family or t is None or not t.calls:
        return None
    return 100.0 * run.flops_per_call * t.calls / (t.window_s * _precision(run)["flops_per_s"])


# B1 and B2 of the port (kernels/csrc/attention_fwd.cu, attention_bwd.cu), and
# PyTorch's own fused attention kernels
ATTENTION_KERNELS = (r"^void (\(anonymous namespace\)::)?"
                     r"(attention_fwd_kernel|bwd_kernel|delta_kernel)<"
                     r"|fmha|flash_fwd|flash_bwd|efficient_attention|cutlassF|cutlassB")


def attention_roofline(run, family: str):
    """Attention's least time at the sites the driver declared for one call
    (``run.attention_sites``) over the device time of the attention kernels
    in the traced window, %."""
    t = run.trace
    if run.family != family or t is None or not t.calls or not run.attention_sites:
        return None
    seconds, n = t.kernel_seconds(ATTENTION_KERNELS)
    if not n:
        return None
    p = _precision(run)
    least = attention.least_seconds(run.attention_sites, p["attention_itemsize"],
                                    p["attention_flops_per_s"],
                                    manifest.peaks(run.cell.root)["hbm_bytes_per_s"])
    return 100.0 * least * t.calls / seconds
