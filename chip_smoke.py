#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``ieagan_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from a checkout of the repository (any working directory); it needs one
CUDA card and ``nvcc`` (``$CUDA_HOME/bin``, ``PATH`` or ``/usr/local/cuda``).
Phases, each timed on a line of its own:

1. device: the card's name and power limit; TF32 off, as the JAX deploy path
   is fp32;
2. build: every kernel under ``ieagan_torch/kernels/csrc`` with nvcc, in
   parallel, into the ignored ``ieagan_torch/kernels/_build``;
3. kernel vs plain: the fused attention forward (B1) against its plain
   PyTorch version at the three attention sites of the model, f32 and bf16,
   with times of the kernel, the plain version, ``scaled_dot_product_attention``
   (a yardstick only; the port never calls it) and the card's bound;
4. main path: ``Model.restore(best0)`` from the checkpoint in the repo, then
   ``generate``, ``generate_batched`` and ``generate_block`` as a user calls
   them; shapes, finite values, ADU range, the kernel's launch count, the
   fused model against the same model with plain attention, and the event
   against the JAX package's numbers in ``golden_best0.json``; time per
   event.

The last lines are the kernel table as JSON, the card as ``nvidia-smi``
reports it, and ``{"ok": true, "device": {...}}``. Any failed check raises,
so the script exits non-zero without that last line.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(ROOT, "artifacts", "flagship_r4b")

# (name, B, Lq, Lkv, dk, dv, scale): B1's call sites. RR_G is the generator's
# relational-reasoning attention as generate() gives it (1 event x 2 heads);
# RR_D and D SA are the discriminator's sites at flagship widths.
SITES = [
    ("RR_G", 2, 40, 40, 64, 64, 0.125),
    ("RR_D", 4, 40, 40, 128, 128, 128 ** -0.5),
    ("D_SA", 2, 3072, 768, 32, 128, 1.0),
]
# |kernel - plain| <= ATOL + RTOL * |plain|. f32: scores of up to 128 products
# at |s| up to ~20 (scale 1 at D_SA) carry ~1e-6 relative rounding that exp
# amplifies; 1e-4 bounds it. bf16: o is rounded to bf16 on both sides from
# f32 sums that may straddle a rounding boundary: one bf16 ulp (2**-8
# relative); lse stays f32.
TOLERANCES = {"float32": {"o": (1e-4, 1e-4), "lse": (1e-4, 1e-4)},
              "bfloat16": {"o": (2e-2, 1e-2), "lse": (1e-4, 1e-4)}}
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # H100 SXM: fp32 non-tensor, bf16 dense
PEAK_BYTES = 3.35e12
# Fused vs plain attention, max over the whole tanh output of the golden
# event: the attention outputs differ by rounding (~1e-7) and the generator
# amplifies that (3.9e-5 between the two plain CPU compositions). 5e-4 is the
# bound the JAX package holds its generator to against the reference model.
FUSED_VS_PLAIN_ATOL = 5e-4


def phase(name, t0):
    print(f"phase {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps=20, inner=10):
    """Median over ``reps`` of CUDA-event time of ``inner`` back-to-back
    calls, per call, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return sorted(times)[len(times) // 2]


def bound(b, lq, lkv, dk, dv, itemsize, dtype_name):
    """Least time for B1 on the card: each input read once, each output
    written once, against the products at the type's peak rate."""
    nbytes = (b * lq * dk + b * lkv * dk + b * lkv * dv + b * lq * dv) * itemsize + b * lq * 4
    flops = 2.0 * b * lq * lkv * (dk + dv)
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_err(got, want, atol, rtol):
    err = (got.float() - want.float()).abs()
    ok = bool((err <= atol + rtol * want.float().abs()).all())
    return float(err.max()), ok


def kernel_vs_plain(torch, attention_fwd, attention_fwd_plain):
    """Phase 3: B1 against its plain version at each site and type."""
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, b, lq, lkv, dk, dv, scale in SITES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).removeprefix("torch.")
            q = torch.randn((b, lq, dk), generator=gen, device="cuda").to(dtype)
            k = torch.randn((b, lkv, dk), generator=gen, device="cuda").to(dtype)
            v = torch.randn((b, lkv, dv), generator=gen, device="cuda").to(dtype)
            o, lse = attention_fwd(q, k, v, scale)
            o_ref, lse_ref = attention_fwd_plain(q, k, v, scale)
            torch.cuda.synchronize()
            tol = TOLERANCES[dname]
            o_err, o_ok = max_err(o, o_ref, *tol["o"])
            lse_err, lse_ok = max_err(lse, lse_ref, *tol["lse"])
            q4, k4, v4 = (t.unsqueeze(1) for t in (q, k, v))
            row = {
                "site": name, "dtype": dname, "shape": [b, lq, lkv, dk, dv],
                "max_abs_err_o": o_err, "max_abs_err_lse": lse_err,
                "tolerance": tol,
                "ms": time_ms(torch, lambda: attention_fwd(q, k, v, scale)),
                "plain_ms": time_ms(torch, lambda: attention_fwd_plain(q, k, v, scale)),
                "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, scale=scale)),
            }
            row["bound_ms"], row["bound_by"] = bound(b, lq, lkv, dk, dv, q.element_size(), dname)
            print("B1 " + json.dumps(row), flush=True)
            if not (o_ok and lse_ok):
                raise SystemExit(f"B1 disagrees with its plain version at {name} {dname}: "
                                 f"o {o_err:.3e}, lse {lse_err:.3e}, tolerance {tol}")
            rows.append(row)
    return rows


def check_events(np, events, shape, what):
    arr = events if isinstance(events, np.ndarray) else events.cpu().numpy()
    if arr.shape != shape:
        raise SystemExit(f"{what}: shape {arr.shape}, expected {shape}")
    if not np.isfinite(arr).all():
        raise SystemExit(f"{what}: non-finite values")
    if arr.min() < 0 or arr.max() > 255:
        raise SystemExit(f"{what}: values outside [0, 255]: {arr.min()}..{arr.max()}")
    print(f"{what}: shape {arr.shape}, ADU {arr.min():.3f}..{arr.max():.3f}, "
          f"mean {arr.mean():.5f}, nonzero {float((arr > 0).mean()):.5f}", flush=True)


def main_path(torch, np):
    """Phase 4: the deployment path as a user drives it."""
    from ieagan_torch.deploy import Model, generate, generate_batched, generate_block
    from ieagan_torch.deploy import golden
    from ieagan_torch.kernels.flash_attention import attention_fwd

    t0 = time.perf_counter()
    model = Model.restore(CHECKPOINT, tag="best0", device="cuda")
    print(f"restore best0: {time.perf_counter() - t0:.2f} s", flush=True)
    es, width = model.event_size, 256 * model.config["H_base"]
    gen = torch.Generator(device="cuda").manual_seed(415)

    attention_fwd.launches = 0
    singles = [generate(model, gen) for _ in range(2)]
    batched = generate_batched(model, 4, gen)
    block = generate_block(model, 1, 2, gen)
    torch.cuda.synchronize()
    launches = attention_fwd.launches
    rrm_calls = len(singles) + 1 + 2
    print(f"main path: {rrm_calls} generator calls, {launches} B1 launches", flush=True)
    if launches != rrm_calls:
        raise SystemExit(f"B1 launched {launches} times for {rrm_calls} RRM calls")
    for i, ev in enumerate(singles):
        check_events(np, ev, (es, 250, width), f"generate #{i}")
    check_events(np, batched, (4 * es, 250, width), "generate_batched(4)")
    check_events(np, block, (2 * es, 250, width), "generate_block(1, 2)")

    g = golden.load()
    z_np, rdof_np = golden.inputs(g["seed"])
    z, rdof = torch.tensor(z_np, device="cuda"), torch.tensor(rdof_np, device="cuda")
    plain_model = Model.restore(CHECKPOINT, tag="best0", device="cuda",
                                config={"use_pallas_attention": False})
    with torch.inference_mode():
        tanh = model.G(z, model.labels(1), rdof)
        tanh_plain = plain_model.G(z, model.labels(1), rdof)
        events = model.events(z, rdof)
    fused_err = float((tanh - tanh_plain).abs().max())
    print(f"fused vs plain attention, tanh output: max abs diff {fused_err:.3e} "
          f"(tolerance {FUSED_VS_PLAIN_ATOL})", flush=True)
    if not fused_err <= FUSED_VS_PLAIN_ATOL:
        raise SystemExit("the fused model disagrees with the plain-attention model")
    summary = golden.summarize(tanh.cpu().numpy(), events.cpu().numpy(),
                               np.asarray(g["index"]))
    result = golden.compare(g, summary)
    print("golden best0: " + json.dumps(result) + f" (tolerances: tanh "
          f"{golden.TANH_ATOL}, ADU sum rel {golden.ADU_SUM_RTOL}, nonzero "
          f"{golden.NONZERO_ATOL})", flush=True)
    if not (result["tanh_ok"] and result["adu_sum_ok"] and result["nonzero_ok"]):
        raise SystemExit("the card's best0 event disagrees with golden_best0.json")

    per_event = {}
    for events_per_call in (1, 4):
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            generate_batched(model, events_per_call, gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3 / events_per_call)
        per_event[events_per_call] = sorted(times)[len(times) // 2]
        print(f"generate_batched({events_per_call}): {per_event[events_per_call]:.2f} "
              f"ms per event (median of 4, host clock after synchronize)", flush=True)
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    return launches


def main():
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, ROOT)
    from ieagan_torch.kernels import build
    from ieagan_torch.kernels.flash_attention import attention_fwd, attention_fwd_plain

    smi = nvidia_smi()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"nvidia-smi: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    phase("device", t0)

    t0 = time.perf_counter()
    for name, res in build.build().items():
        ptxas = [ln.strip() for ln in res["log"].splitlines() if "ptxas info" in ln]
        print(f"built {name} in {res['seconds']:.2f} s -> {os.path.relpath(res['path'], ROOT)}",
              flush=True)
        for ln in ptxas:
            print(f"  {ln}", flush=True)
    phase("build", t0)

    t0 = time.perf_counter()
    rows = kernel_vs_plain(torch, attention_fwd, attention_fwd_plain)
    phase("kernel vs plain", t0)

    t0 = time.perf_counter()
    launches = main_path(torch, np)
    phase("main path", t0)

    main_row = next(r for r in rows if r["site"] == "RR_G" and r["dtype"] == "float32")
    kernels = [{
        "name": "attention_fwd (B1)", "route": "cuda",
        "source": "ieagan_torch/kernels/csrc/attention_fwd.cu",
        "replaces": "ieagan_tpu/ops/pallas/flash_attention.py:63",
        "launches": launches, "max_abs_err": main_row["max_abs_err_o"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }]
    print(f"total: {time.perf_counter() - t_all:.2f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
