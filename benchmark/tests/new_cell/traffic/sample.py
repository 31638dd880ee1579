"""Traffic kind ``sample``: an image sampler, a kind of call the benchmark's
own drivers do not make. One caller in a closed loop; each call is the
port's ``Generator`` over ``images_per_call`` latents with labels drawn
uniformly from the classes, and ends at the device's synchronize.
``tests/test_bench_new_cell.py`` adds this driver, its mix, configuration
and cell to a copy of the tree as new files, and runs them there.

Parameters (``traffic/<mix>.json``): ``images_per_call``, ``warmup_calls``,
``trace_calls``.

Set-up makes G's state from the seed (``harness/weights.py``); the window's
first call is compared, once the window has closed, with the plain
reference (``reference/model.py``, float32) over the same latents and
labels: ``tanh_gap``, the largest difference of the outputs. On the CPU,
``memory_peak_bytes`` stands in with the bytes of G's state.
"""

from __future__ import annotations

import time

from benchmark.harness import weights
from benchmark.harness.run_state import Check, subseed
from benchmark.reference import model as ref
from benchmark.work import model_flops


def declare(r):
    """A call: ``images_per_call`` images, G's forward, and G's
    self-attention at each resolution of ``G_attn`` (the 64x64 table's
    channels, ``G_ch`` x 4 at 32x32)."""
    cfg, images = r.config, int(r.cell.traffic["images_per_call"])
    r.family, r.unit, r.units_per_call = "generate", "images", images
    r.flops_per_call = model_flops.g_forward(cfg, images)
    c = cfg["G_ch"] * 4
    r.attention_sites = [("G_SA", (images, hw, hw // 4, c // 8, c // 2), 1, 0)
                         for hw in (int(res) ** 2 * cfg["H_base"]
                                    for res in str(cfg["G_attn"]).split("_"))]


def run(r, mode: str = "program", fault: str | None = None):
    """Drive the cell into ``r``; the program only (no control, no fault)."""
    import torch
    from ieagan_torch.models.generator import Generator

    traffic, cfg, dev = r.cell.traffic, r.config, r.device
    declare(r)
    n = r.units_per_call
    r.phase("import")

    S = weights.make(ref.g_spec(cfg), subseed(r.seed, "weights"), dev)
    G = Generator.from_config(cfg).to(dev).eval()
    G.load_state_dict(S, strict=True)
    r.phase("weights")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def draw(gen):
        z = torch.randn((n, cfg["dim_z"]), generator=gen, device=dev)
        return z, torch.randint(0, cfg["n_classes"], (n,), generator=gen, device=dev)

    call = torch.no_grad()(lambda z, y: G(z, y))
    warm = torch.Generator(device=dev).manual_seed(subseed(r.seed, "warm-up"))
    for _ in range(int(traffic["warmup_calls"])):
        call(*draw(warm))
    sync()
    r.phase("warm-up")

    gen = torch.Generator(device=dev).manual_seed(subseed(r.seed, "window"))
    limit_calls = int(traffic["trace_calls"]) if r.traced else None
    kept = {}

    def window():
        import contextlib
        span_ = (torch.profiler.record_function if r.traced
                 else lambda name: contextlib.nullcontext())
        times = []
        r.window_started()
        t_open = time.perf_counter()
        with span_("bench.window"):
            while True:
                z, y = draw(gen)
                t0 = time.perf_counter()
                with span_("bench.call"):
                    out = call(z, y)
                    sync()
                t1 = time.perf_counter()
                times.append(t1 - t0)
                kept.setdefault("first", (z, y, out))
                if t1 - t_open >= r.seconds or (limit_calls and len(times) >= limit_calls):
                    break
        return times, t1 - t_open

    if r.traced:
        from benchmark.harness.trace import Traced
        with Traced() as traced:
            times, r.window_s = window()
        r.trace = traced.trace
    else:
        times, r.window_s = window()
    r.calls, r.call_seconds = len(times), times
    r.attempted = r.calls
    r.memory_peak_bytes = (int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else
                           sum(t.numel() * t.element_size() for t in S.values()))

    del G, call
    z, y, out = kept.pop("first")
    with torch.no_grad():
        t_ref = ref.generator(cfg, S, z, y, None, ref.Ops("float32"), train=False)
    gap = float((out.float() - t_ref).abs().max())
    r.checks = [Check("tanh_gap", gap, float(r.cell.workload["limits"]["tanh_gap"]))]
