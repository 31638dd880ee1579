"""The benchmark of ``ieagan_torch`` on an NVIDIA H100.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` on the machine it starts on: set-up
(weights and inputs made on the device from ``--seed``, warm-up), a window of
``--seconds`` of the cell's traffic, then the comparison with the plain
reference that decides ``correct``. The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics from the
device trace and the program's spans), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its limit.
The lines before it (and the set-up by phase, the card's name, power limit
and clocks, and on a traced run the per-span table) go to standard error,
whose last lines are the compared numbers.

Exits non-zero, printing no result, without a CUDA device (or with fewer
than the cell asks for), and when ``jax``, ``jaxlib``, ``flax``, ``optax``
or ``ieagan_tpu`` is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """When this process started (``time.time()``), from /proc where Linux
    has it."""
    try:
        with open("/proc/self/stat", encoding="ascii") as fp:
            ticks = int(fp.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime", encoding="ascii") as fp:
            uptime = float(fp.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


STARTED = _process_start()
ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ieagan_tpu")


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)


def use_checkout_caches(root: Path = ROOT):
    """Build and kernel caches at fixed paths inside the checkout (the port
    builds its own kernels into ``ieagan_torch/kernels/_build/``)."""
    cache = root / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,clocks.max.sm,"
             "clocks.mem,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f"not read ({err})"


def measure(cell, seed: int, seconds: float, traced: bool, device, mode: str = "program",
            fault: str | None = None, config: dict | None = None, started: float | None = None):
    """Run ``cell`` (``harness.manifest.Cell``) on ``device`` and return its
    ``harness.run_state.Run``. ``config`` replaces the program's
    configuration (tests run tiny ones); ``mode`` and ``fault`` go to the
    traffic driver."""
    from ieagan_torch.core.config import DEFAULT_CONFIG

    from benchmark.harness import manifest
    from benchmark.harness.run_state import Run

    if config is None:
        config = dict(DEFAULT_CONFIG, **cell.config_file["config"])
    run = Run(cell=cell, config=config, seed=int(seed), seconds=float(seconds), traced=traced,
              device=device, started=started if started is not None else time.time())
    manifest.driver(cell.kind, cell.root).run(run, mode=mode, fault=fault)
    return run


def result(run, device_kind: str, count: int) -> dict:
    """The result line of ``run``."""
    from benchmark.harness import manifest

    metrics = {}
    for m in run.cell.metrics(run.traced):
        value = manifest.reader(m["name"], run.cell.root).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_kind, "count": count,
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    out = {"correct": run.correct, "attempted": int(run.attempted), "failed": int(run.failed),
           "metrics": metrics, "device": device}
    if run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.device_ops,
                            "idle_gaps": run.trace.idle_gaps}
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in run.checks}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    say = lambda *a: print(*a, file=sys.stderr, flush=True)

    use_checkout_caches()
    from benchmark.harness import manifest
    cell = manifest.cell(args.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        say(f"{args.workload} needs {cell.chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(device)
    say(f"cell {cell.name}: config {cell.config_name}, traffic {cell.traffic_name}, "
        f"seed {args.seed}, {args.seconds:g} s, trace {args.trace}")
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind} x "
        f"{torch.cuda.device_count()}")

    run = measure(cell, args.seed, args.seconds, bool(args.trace), device, started=STARTED)
    say("nvidia-smi (name, power limit, draw, SM clock, max SM clock, memory clock, "
        f"temperature), after the window: {nvidia_smi()}")
    say("set-up by phase (s): " + ", ".join(f"{n} {s:.3f}" for n, s in run.phases)
        + f"; setup_s {run.setup_s:.3f}")
    say(f"window: {run.calls} calls in {run.window_s:.3f} s; notes: "
        + json.dumps(run.notes, default=str))
    if run.trace is not None and run.trace.spans is not None:
        from benchmark.harness import spans
        say("\n".join(spans.table(run.trace.spans, run.family)))

    found = forbidden_modules()
    if found:
        say("refused: modules of the JAX package or JAX are loaded: " + ", ".join(found))
        return 3
    line = result(run, kind, cell.chips)
    for c in run.checks:
        say(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
