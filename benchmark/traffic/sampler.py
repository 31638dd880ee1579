"""Traffic kind ``sampler``: a class-conditional image sampler. One caller
in a closed loop; each call is ``ieagan_torch.deploy.inference.
sample_batched(model, images_per_call, generator)`` (z standard normal, then
labels uniform over the classes, G's forward; [-1, 1] images, no
postprocess), and the call ends at the ``torch.cuda.synchronize()`` that a
user's copy-out waits for.

Parameters (``traffic/<mix>.json``): ``images_per_call``, ``warmup_calls``,
``sample_calls`` (calls whose outputs are compared, the first of the window
and others drawn from the seed among its first ``sample_span``),
``trace_calls`` (the calls a traced run profiles) and ``reference_images``
(the images the reference computes at once, so that it fits beside the
kept outputs).

Set-up makes G's state from the seed (``harness/weights.py`` over
``reference/biggan_deep.py``'s layout) and loads it into the program's
``Model``; the window draws from a ``torch.Generator`` of its own. Once the
window has closed the program is freed, and the plain reference (float32,
TF32 off) computes each sampled call again from the same z and labels:
``tanh_gap`` is the largest |program - reference| over every pixel and
channel of the compared calls.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.harness import weights
from benchmark.harness.run_state import Check, subseed
from benchmark.reference import biggan_deep as ref
from benchmark.work import biggan_deep as work


def _draw(cfg, generator, images, device):
    """A call's (z, labels) as ``Model.draw_images`` makes them: z standard
    normal, then labels uniform over the classes, from the call's
    generator."""
    import torch
    z = torch.randn((images, cfg["dim_z"]), generator=generator, device=device)
    y = torch.randint(0, int(cfg["n_classes"]), (images,), generator=generator, device=device)
    return z, y


def reference_call(cfg, S, z, y, block, precision="float32"):
    """The reference generator over a call's latents, ``block`` images at a
    time: (B, H, W, C)."""
    import torch
    return torch.cat([ref.generator(cfg, S, z[i:i + block], y[i:i + block], precision)
                      for i in range(0, z.shape[0], block)])


def declare(r):
    """What a call of the cell is: ``images_per_call`` images, G's forward
    with the RGB head, and G's self-attention sites."""
    images = int(r.cell.traffic["images_per_call"])
    r.family, r.unit, r.units_per_call = "generate", "images", images
    r.flops_per_call = work.g_forward(r.config, images)
    r.attention_sites = work.sites(r.config, images)


def run(r, mode: str = "program", fault: str | None = None):
    """Drive the cell into ``r`` (``harness.run_state.Run``). ``mode``
    ``control`` puts the reference at the cell's control precision in the
    program's place; ``fault`` plants a fault in the timed path (tests)."""
    import torch
    from ieagan_torch.deploy.inference import Model, sample_batched

    traffic, cfg, dev = r.cell.traffic, r.config, r.device
    declare(r)
    images, block = r.units_per_call, int(traffic["reference_images"])
    r.phase("import")

    S = weights.make(ref.g_spec(cfg), subseed(r.seed, "weights"), dev)
    model = Model(config=cfg, device=dev, dtype=torch.float32, _random_init=False)
    model.G.load_state_dict(S, strict=True)
    r.phase("weights")
    r.notes["backends"] = dict(cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
                               matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if mode == "control":
        precision = r.cell.workload["control"]
        call = lambda gen: reference_call(cfg, S, *_draw(cfg, gen, images, dev), block,
                                          precision)
    else:
        call = lambda gen: sample_batched(model, images, gen)

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
    gaps, values = [], 0
    for i in sorted(kept):
        state, out = kept.pop(i)
        g = torch.Generator(device=dev)
        g.set_state(state)
        want = reference_call(cfg, S, *_draw(cfg, g, images, dev), block)
        gaps.append(float((out.float() - want).abs().max()))
        values += out.numel()
        del out, want
    limit = float(r.cell.workload["limits"]["tanh_gap"])
    r.attempted, r.failed = r.calls, sum(1 for g in gaps if not g <= limit)
    r.notes["compared"] = dict(calls=len(gaps), values=values, gaps=gaps)
    r.checks = [Check("tanh_gap", max(gaps) if gaps else float("inf"), limit)]
