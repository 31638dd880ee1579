"""What one run of a cell knows, handed from the traffic driver to the
metric readers and the result line."""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field


def subseed(seed: int, tag: str) -> int:
    """A seed of its own for each use of the run's ``--seed``."""
    return int(hashlib.sha256(f"{int(seed)}:{tag}".encode()).hexdigest()[:15], 16)


@dataclass
class Check:
    """One number of the comparison that decides ``correct``, beside its
    limit: the run is correct where every value is at or below its limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclass
class Run:
    cell: object                    # harness.manifest.Cell
    config: dict                    # the program's configuration as run
    seed: int
    seconds: float
    traced: bool
    device: object = None
    started: float = 0.0            # process start, time.time()
    phases: list = field(default_factory=list)      # [(name, seconds)] of set-up
    # what one call of the window is, set by the traffic driver and read by
    # the readers: its family ("generate": a generator call; "train": a step),
    # what ``units_per_call`` counts ("events" or "images"), and every
    # attention of one call, [(site, (B, Lq, Lkv, dk, dv), forwards,
    # backwards)] as ``work/attention.py::sites`` lists them
    family: str = ""
    unit: str = ""
    units_per_call: int = 0
    flops_per_call: float = 0.0     # model FLOPs of one call (work/model_flops.py)
    attention_sites: list = field(default_factory=list)
    # the measured window (filled by the traffic driver)
    calls: int = 0                  # calls completed
    call_seconds: list = field(default_factory=list)
    window_s: float = 0.0
    setup_s: float = 0.0
    memory_peak_bytes: int = 0
    trace: object = None            # harness.trace.Trace of a traced run
    attempted: int = 0
    failed: int = 0
    checks: list = field(default_factory=list)      # [Check]
    notes: dict = field(default_factory=dict)       # printed on earlier lines
    _mark: float = 0.0

    def phase(self, name: str):
        """Close the set-up phase ``name`` at now."""
        now = time.time()
        self.phases.append((name, now - (self._mark or self.started)))
        self._mark = now

    def window_started(self):
        """Set-up ends: the first timed call starts now."""
        self.setup_s = time.time() - self.started

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks) and self.failed == 0
