"""Traffic kind ``generate``: one caller in a closed loop, each call
``ieagan_torch.deploy.inference.generate_batched(model, events_per_call,
generator)``, as the basf2 producer calls it, and the call ends at the
``torch.cuda.synchronize()`` that the producer's copy-out waits for.

Parameters (``traffic/<mix>.json``): ``events_per_call``, ``warmup_calls``,
``sample_calls`` (calls whose outputs are compared, the first of the window
and others drawn from the seed among its first ``sample_span``), and
``trace_calls`` (the calls a traced run profiles).

Set-up makes the generator's state from the seed (``harness/weights.py``)
and loads it into the program's ``Model``; the window draws its latents from
a ``torch.Generator`` of its own. Once the window has closed the program is
freed, and the plain reference (``reference/model.py``, float32 products,
TF32 off) generates each sampled call again from the same latents; each is
held to ``tanh_gap``.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.harness import compare, weights
from benchmark.harness.run_state import Check, subseed
from benchmark.reference import model as ref
from benchmark.work import attention, model_flops


def _draw(cfg, generator, events, device):
    """A call's (z, rdof) as ``Model.draw`` makes them: z, then rdof, each
    standard normal from the call's generator."""
    import torch
    n = events * cfg["n_classes"]
    z = torch.randn((n, cfg["dim_z"]), generator=generator, device=device)
    rdof = torch.randn((n, cfg["rdof_dim"]), generator=generator, device=device)
    return z, rdof


def _latents(cfg, generator_state, events, device):
    """The latents of the call that started at ``generator_state``."""
    import torch
    g = torch.Generator(device=device)
    g.set_state(generator_state)
    return _draw(cfg, g, events, device)


def reference_call(cfg, S, z, rdof, ops):
    """The reference generator over a call's latents, one event at a time:
    (B, 256, W, 1) before the postprocess."""
    import torch
    es = cfg["n_classes"]
    y = torch.arange(es, device=z.device)
    out = [ref.generator(cfg, S, z[i:i + es], y, rdof[i:i + es], ops, train=False)
           for i in range(0, z.shape[0], es)]
    return torch.cat(out)


def declare(r):
    """What a call of the cell is: a generator call of ``events_per_call``
    events, its model FLOPs and its attention sites."""
    events = int(r.cell.traffic["events_per_call"])
    r.family, r.unit, r.units_per_call = "generate", "events", events
    r.flops_per_call = model_flops.generate_call(r.config, events)
    r.attention_sites = attention.sites(r.config, "generate", events)


def run(r, mode: str = "program", fault: str | None = None):
    """Drive the cell into ``r`` (``harness.run_state.Run``). ``mode``
    ``control`` puts the reference at the cell's control precision in the
    program's place; ``fault`` plants a fault in the timed path (tests)."""
    import torch
    from ieagan_torch.deploy.inference import Model, generate_batched

    traffic, cfg, dev = r.cell.traffic, r.config, r.device
    declare(r)
    events = r.units_per_call
    r.phase("import")

    spec = ref.g_spec(cfg)
    S = weights.make(spec, subseed(r.seed, "weights"), dev)
    model = Model(config=cfg, device=dev, dtype=torch.float32, _random_init=False)
    model.G.load_state_dict(S, strict=True)
    r.phase("weights")
    r.notes["backends"] = dict(cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
                               matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if mode == "control":
        ops = ref.Ops(r.cell.workload["control"])

        @torch.no_grad()
        def call(gen):
            return ref.postprocess(reference_call(cfg, S, *_draw(cfg, gen, events, dev), ops))
    else:
        call = lambda gen: generate_batched(model, events, gen)

    warm = torch.Generator(device=dev).manual_seed(subseed(r.seed, "warm-up"))
    for _ in range(int(traffic["warmup_calls"])):
        call(warm)
    sync()
    r.phase("warm-up (kernel build, cuDNN plans)")

    rng = np.random.default_rng(subseed(r.seed, "sample"))
    span = int(traffic["sample_span"])
    sample = {0} | {int(i) for i in rng.choice(np.arange(1, span), int(traffic["sample_calls"]) - 1,
                                               replace=False)}
    gen = torch.Generator(device=dev).manual_seed(subseed(r.seed, "window"))
    kept = {}
    limit_calls = int(traffic["trace_calls"]) if r.traced else None

    def window():
        import contextlib
        span_ = (torch.profiler.record_function if r.traced
                 else lambda name: contextlib.nullcontext())
        times, i = [], 0
        if r.traced:
            r.phase("profiler start")
        r.window_started()
        t_open = time.perf_counter()
        with span_("bench.window"):
            while True:
                state = gen.get_state() if i in sample else None
                t0 = time.perf_counter()
                with span_("bench.call"):
                    out = call(gen)
                    sync()
                t1 = time.perf_counter()
                times.append(t1 - t0)
                if state is not None:
                    if fault == "altered":   # one image left empty
                        out = out.clone()
                        out[0] = 0.0
                    kept[i] = (state, out)
                i += 1
                if t1 - t_open >= r.seconds or (limit_calls and i >= limit_calls):
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
    r.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0

    # the reference, once the program is freed
    del model, call
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    f32 = ref.Ops("float32")
    gaps, pixels = [], 0
    with torch.no_grad():
        for i in sorted(kept):
            state, out = kept.pop(i)
            t_ref = reference_call(cfg, S, *_latents(cfg, state, events, dev), f32)
            gap, n = compare.tanh_gap(out, t_ref, float(r.cell.workload["threshold_margin"]))
            gaps.append(gap)
            pixels += n
    limit = float(r.cell.workload["limits"]["tanh_gap"])
    r.attempted, r.failed = r.calls, sum(1 for g in gaps if not g <= limit)
    r.notes["compared"] = dict(calls=len(gaps), pixels=pixels, gaps=[float(g) for g in gaps])
    r.checks = [Check("tanh_gap", max(gaps) if gaps else float("inf"), limit)]
