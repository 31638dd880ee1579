#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``ieagan_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from a checkout of the repository (any working directory); it needs one
CUDA card and ``nvcc`` (``$CUDA_HOME/bin``, ``PATH`` or ``/usr/local/cuda``).
Phases, each timed on a line of its own:

1. device: the card's name and power limit; TF32 off, as the JAX deploy path
   is fp32;
2. build: every kernel under ``ieagan_torch/kernels/csrc`` with nvcc, in
   parallel, and the producer's sparse-digit library with g++, into the
   ignored ``ieagan_torch/kernels/_build``;
3. kernel vs plain: the fused attention forward (B1) against its plain
   PyTorch version at the three attention sites of the model, f32 and bf16,
   with times of the kernel, the plain version, ``scaled_dot_product_attention``
   (a yardstick only; the port never calls it) and the card's bound;
3b. the same for the fused attention backward (B2), against its plain version
   and SDPA's backward, at the three sites as the train step gives them;
3c. ``ieagan_torch.kernels.selfcheck.run_check`` in f32 and bf16: forward and
   backward of ``FlashAttention`` against the plain composition, scored by
   normalized error as the JAX package's Pallas self-check scores them;
4. deployment path: ``Model.restore(best0)`` from the checkpoint in the repo,
   then ``generate``, ``generate_batched`` and ``generate_block`` as a user
   calls them; shapes, finite values, ADU range, the kernel's launch count,
   the fused model against the same model with plain attention, and the
   event against the JAX package's numbers in ``golden_best0.json``; time per
   event;
5. training path: ``restore_train_state(copy16000)`` and three full-width
   steps of ``make_train_step`` on one event of synthetic reals (uniform in
   [-1, 1], as the JAX driver's debug batch); finite metrics, weights that
   moved, spectral norms logged, B1 and B2 launches per step, the EMA
   update, the fused step against the plain-attention step from the same
   state and draws, and the time per step;
6. golden step: the first step from ``copy16000`` on the golden inputs and
   draws against the JAX package's numbers in
   ``ieagan_torch/train/golden_step_copy16000.json``;
7. training entry point: ``train/driver.py::run`` at the flagship width under
   the default bfloat16 policy, on the debug path, into a temporary run dir:
   four steps with logs, singular values and checkpoints every two steps,
   then a resume to step six with a ``torch.profiler`` trace of steps five
   and six; the run dir's files, every component of ``copy2``/``copy4`` read
   back bit-equal to the state in memory (Adam's moments and counts too),
   the resumed ``itr`` and counts, B1/B2 launches per step with bf16 inputs,
   finite metrics; time per step, peak memory, seconds per save, and the
   trace's top device ops and the device's idle share; then the dataset
   path: a PNG event tree loaded onto the card (batches equal to the host's)
   and two driver steps on it with the uint8 upload;
8. bf16 against f32: one step from ``copy16000`` under each policy for each
   of three seeds of draws, capturing the gradients; the bf16 step within
   the stated bounds of the f32 step on the same draws (metrics, module
   gradient norms, per-leaf cosine) and outside them against the f32 step
   on other draws; two yardsticks printed beside them (the f32 step with
   TF32, and bf16 against f32 with D's learning rate 0).
9. evaluation and production, with ``best0``: (a) the Inception graph at
   full width with the numpy-seeded fallback weights against the JAX
   package's features in ``ieagan_torch/eval/golden_inception.json`` (a
   control on the other half of the images must break the bounds), ms per
   image with TF32 off and on; (b) the device resize of the golden event
   against PIL; (c) ``make_generator_fn`` (trunc 1, permuted labels) for
   2,000 images: features, device moments against host f64 ``np.cov``, FID
   and KID against stats minted by ``make_custom_stats`` from phase 7's PNG
   tree into a temporary ``IEAGAN_STATS_DIR``, the self-check, B1 launches
   per generator call, seconds per FID; (d) ``train/driver.py::run``
   reaching ``test_every``, once with the FID subprocess and once in
   process; (e) ``EventProducer`` (sparse digits through the C++ library
   built in phase 2) against its blocks' pixels and the golden counts,
   events per second; (f) ``generate_stats`` against the host path. The
   phase reads nothing under ``stats/``: it mints its own reference
   statistics and runs Inception with the seeded fallback weights.

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

# (name, B, Lq, Lkv, dk, dv, scale): the attention sites. RR_G is the
# generator's relational-reasoning attention as generate() and the train step
# give it (1 event x 2 heads); RR_D and D SA are the discriminator's sites at
# flagship widths, D SA once at B=2 (as checked since the first slice) and
# once at the train step's batch of 40 images. ODD and WIDE are no site of the
# model: widths that are padded inside the kernels ((5, 7) -> (32, 32),
# (100, 48) -> (128, 64)), ragged lengths, and rows that are not 16-byte
# aligned (ODD in both types, WIDE in bf16), so the element-wise load path runs.
SITES = [
    ("RR_G", 2, 40, 40, 64, 64, 0.125),
    ("RR_D", 4, 40, 40, 128, 128, 128 ** -0.5),
    ("D_SA", 2, 3072, 768, 32, 128, 1.0),
    ("D_SA", 40, 3072, 768, 32, 128, 1.0),
    ("ODD", 3, 77, 45, 5, 7, 0.5),
    ("WIDE", 3, 130, 200, 100, 48, 0.2),
]
BWD_SITES = [SITES[0], SITES[1], SITES[3], SITES[4], SITES[5]]
# |kernel - plain| <= ATOL + RTOL * |plain|. f32: scores of up to 128 products
# at |s| up to ~20 (scale 1 at D_SA) carry ~1e-6 relative rounding that exp
# amplifies; 1e-4 bounds it. bf16: o is rounded to bf16 on both sides from
# f32 sums that may straddle a rounding boundary: one bf16 ulp (2**-8
# relative); lse stays f32.
TOLERANCES = {"float32": {"o": (1e-4, 1e-4), "lse": (1e-4, 1e-4)},
              "bfloat16": {"o": (2e-2, 1e-2), "lse": (1e-4, 1e-4)}}
# B2 against its plain version, on dq, dk, dv: the same reasoning as o (both
# recompute p from the same lse; sums of up to 3072 products run in another
# order; bf16 rounds each gradient once at the end). The plain version is
# taken in f64 (its inputs widened, its gradients rounded to the input type):
# dS = p (dP - delta) multiplies the rounding of s by |dP - delta|, and the
# plain version in f32 does not hold this tolerance at D SA against f64 (each
# f32 row prints its plain_f32_worst_ratio beside the kernel's worst_ratio).
BWD_TOLERANCES = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 1e-2)}
# H100 SXM peaks (dense). f32: the kernels take f32-accurate products on the
# tensor cores as split-TF32, three TF32 products per f32 product, so the least
# time for f32 work is at 495 / 3 TFLOP/s; the 67 TFLOP/s of the f32 pipe
# outside the tensor cores is printed beside it as simt_bound_ms.
PEAK_FLOPS = {"float32": 495e12 / 3, "float32_simt": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
# Fused vs plain attention, max over the whole tanh output of the golden
# event: the attention outputs differ by rounding (~1e-7) and the generator
# amplifies that (3.9e-5 between the two plain CPU compositions). 5e-4 is the
# bound the JAX package holds its generator to against the reference model.
FUSED_VS_PLAIN_ATOL = 5e-4
# Fused against plain attention through one train step, per parameter
# ||fused - plain|| / ||plain|| of the gradient: max < 1e-2 and median < 1e-3,
# the bound the JAX package holds its step to against the reference PyTorch
# model (tests/test_model_parity.py); the metrics within rtol 2e-3, atol 2e-5.
STEP_GRAD_MAX, STEP_GRAD_MEDIAN = 1e-2, 1e-3
STEP_METRIC_RTOL, STEP_METRIC_ATOL = 2e-3, 2e-5
TRAIN_STEPS = 3
# Kernel launches per train step (flagship config, one event): B1 at RR_G in
# both G passes and at RR_D and D SA in all three D passes; B2 wherever the
# loss needs the site's gradient: D SA in all three D passes, RR_D in the D
# phase's real pass and the G phase's pass (the D phase's fake embedding
# enters no D loss), RR_G in the G phase.
B1_PER_STEP, B2_PER_STEP = 2 + 3 * 2, 3 + 2 + 1
# The driver phase (7): the JAX driver's debug run at the flagship width.
DRIVER_RUN = dict(debug=True, debug_batches=4, num_epochs=1, log_interval=1,
                  sv_log_interval=2, save_every=2, test_every=10 ** 6, trace_start=5,
                  trace_steps=1)
DRIVER_METRICS = ("D_loss_real", "D_loss_fake", "unif_loss_d", "iea_loss", "unif_loss_g",
                  "G_loss")
# bf16 against f32 (phase 8): one step from copy16000 under each policy on the
# same reals, for each seed of BF16_SEEDS's draws. Each pair is read by
# step_gap: the six metrics, and per network the gradients' module norms and
# per-leaf cosines. A bf16 step and the f32 step on the same draws (sound)
# must be within every bound of BF16_CHECKS; a bf16 step against the f32 step
# on another seed's draws (the control: the right inputs and weights,
# gradients of the right size in another direction) must break each of them.
# The bounds sit between the two on the H100 (PERF.md, PR 7 findings):
#  * each metric within 0.08 |f32| + 1e-3: sound at most 3.8% (D_loss_fake),
#    every control off by 34% or more in some metric;
#  * D: module norms within 15% (sound at most 10.0%, controls 20% or more),
#    per-leaf cosine median >= 0.995 (sound 0.9986 or more, controls 0.989
#    or less);
#  * G: per-leaf cosine median >= 0.2 (sound 0.37-0.52, controls 0.04 or
#    less). G's gradient at copy16000 is dominated by rounding: the f32 step
#    with TF32 convolutions alone takes its cosine median to 0.93 and its
#    module norms 15% off (D's: 1.0000 and 0.2%), so bf16, 8x coarser, takes
#    them to 0.37-0.52 and 44-59%. G's module norms under bf16 (44-59% off,
#    69% with D's learning rate 0) and under other draws (34-152%) overlap,
#    so they are printed, not bounded.
BF16_SEEDS = (8, 9, 10)
BF16_CHECKS = ("metrics", "G cosine", "D norms", "D cosine")
BF16_METRIC_RTOL, BF16_METRIC_ATOL = 0.08, 1e-3
BF16_D_NORM_RTOL = 0.15
BF16_COS_MEDIAN_MIN = {"G": 0.2, "D": 0.995}


def phase(name, t0):
    print(f"phase {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def ptxas_summary(log):
    """One line per function from nvcc's ``-Xptxas -v`` report: each kernel
    (registers, stack, spills) and each device function compiled on its own
    (stack, spills), by name, type and head widths."""
    import re

    def label(mangled):
        base = re.search(r"\d([a-z][a-z_]*_(?:kernel|block))I", mangled)
        widths = "x".join(re.findall(r"Li(\d+)E", mangled))
        dtype = "bf16" if "bfloat16" in mangled else "f32"
        return f"{base.group(1) if base else mangled} {dtype} {widths}".strip()

    order, props, regs, pending, entry = [], {}, {}, None, None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            pending = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and pending:
            props[pending] = f"stack {m.group(1)} B, spills {m.group(2)}/{m.group(3)} B"
            if pending not in order:
                order.append(pending)
            pending = None
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            entry = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry:
            regs[entry] = f"{m.group(1)} registers"
            if entry not in order:
                order.append(entry)
            entry = None
    return [f"{label(name)}: " + ", ".join(x for x in (regs.get(name), props.get(name)) if x)
            for name in order]


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


def fwd_work(b, lq, lkv, dk, dv, itemsize):
    """B1's least work: (bytes, FLOP). Each input read once, each output
    written once; the two products."""
    nbytes = (b * lq * dk + b * lkv * dk + b * lkv * dv + b * lq * dv) * itemsize + b * lq * 4
    return nbytes, 2.0 * b * lq * lkv * (dk + dv)


def bwd_work(b, lq, lkv, dk, dv, itemsize):
    """B2's least work: q, k, v, o, dO and lse read once, dq, dk, dv written
    once; the five products."""
    nbytes = (2 * (b * lq * dk + b * lkv * dk + b * lkv * dv) + 2 * b * lq * dv) * itemsize \
        + b * lq * 4
    return nbytes, 2.0 * b * lq * lkv * (3 * dk + 2 * dv)


def add_bound(row, nbytes, flops, dtype_name):
    """The row's least time on the card (``bound_ms``, ``bound_by``), the f32
    SIMT bound beside it for f32 rows, and the achieved TFLOP/s."""
    def least(rate):
        t_bytes, t_ops = nbytes / PEAK_BYTES, flops / rate
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")
    row["bound_ms"], row["bound_by"] = least(PEAK_FLOPS[dtype_name])
    if dtype_name == "float32":
        row["simt_bound_ms"] = least(PEAK_FLOPS["float32_simt"])[0]
    row["tflops"] = flops / (row["ms"] * 1e-3) / 1e12


def max_err(got, want, atol, rtol):
    err = (got.float() - want.float()).abs()
    ok = bool((err <= atol + rtol * want.float().abs()).all())
    return float(err.max()), ok


def worst_ratio(got, want, atol, rtol):
    """max |got - want| / (atol + rtol |want|): at most 1 within tolerance."""
    err = (got.double() - want.double()).abs()
    return float((err / (atol + rtol * want.double().abs())).max())


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
            add_bound(row, *fwd_work(b, lq, lkv, dk, dv, q.element_size()), dname)
            print("B1 " + json.dumps(row), flush=True)
            if not (o_ok and lse_ok):
                raise SystemExit(f"B1 disagrees with its plain version at {name} {dname}: "
                                 f"o {o_err:.3e}, lse {lse_err:.3e}, tolerance {tol}")
            rows.append(row)
    return rows


def backward_vs_plain(torch, attention_fwd, attention_bwd, attention_bwd_plain):
    """Phase 3b: B2 against its plain version at each site and type."""
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for name, b, lq, lkv, dk, dv, scale in BWD_SITES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).removeprefix("torch.")
            q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                           for shape in ((b, lq, dk), (b, lkv, dk), (b, lkv, dv), (b, lq, dv)))
            o, lse = attention_fwd(q, k, v, scale)
            got = attention_bwd(q, k, v, o, lse, do, scale)
            want = [t.to(dtype) for t in attention_bwd_plain(
                *(t.double() for t in (q, k, v, o, lse, do)), scale)]
            torch.cuda.synchronize()
            tol = BWD_TOLERANCES[dname]
            errs = [max_err(g, w, *tol) for g, w in zip(got, want)]
            q4, k4, v4 = (t.unsqueeze(1).detach().requires_grad_() for t in (q, k, v))
            o4 = F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
            do4 = do.unsqueeze(1)
            row = {
                "site": name, "dtype": dname, "shape": [b, lq, lkv, dk, dv],
                "max_abs_err_dq": errs[0][0], "max_abs_err_dk": errs[1][0],
                "max_abs_err_dv": errs[2][0], "tolerance": tol,
                "worst_ratio": max(worst_ratio(g, w, *tol) for g, w in zip(got, want)),
                "ms": time_ms(torch, lambda: attention_bwd(q, k, v, o, lse, do, scale)),
                "plain_ms": time_ms(torch, lambda: attention_bwd_plain(q, k, v, o, lse, do,
                                                                       scale)),
                "library_ms": time_ms(torch, lambda: torch.autograd.grad(
                    o4, (q4, k4, v4), do4, retain_graph=True)),
            }
            add_bound(row, *bwd_work(b, lq, lkv, dk, dv, q.element_size()), dname)
            if dtype == torch.float32:
                row["plain_f32_worst_ratio"] = max(
                    worst_ratio(g, w, *tol)
                    for g, w in zip(attention_bwd_plain(q, k, v, o, lse, do, scale), want))
            print("B2 " + json.dumps(row), flush=True)
            if not all(ok for _, ok in errs):
                raise SystemExit(f"B2 disagrees with its plain version at {name} {dname}: "
                                 f"{[e for e, _ in errs]}, tolerance {tol}")
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


def leaf_errors(np, got, want):
    """Per-parameter ||got - want|| / ||want|| of two gradient dicts; leaves
    null in exact arithmetic (norm < 1e-5: conv biases feeding batch norms)
    must be null in both."""
    errs = {}
    for name, w in want.items():
        g, w = got[name].double(), w.double()
        wn, gn = float(w.norm()), float(g.norm())
        if wn < 1e-5:
            if gn >= 1e-5:
                raise SystemExit(f"{name}: null gradient in one step, {gn:.3e} in the other")
            continue
        errs[name] = float((g - w).norm()) / wn
    return errs


def train_path(torch, np):
    """Phase 5: the training path as a user drives it, from copy16000."""
    from ieagan_torch.core.config import DEFAULT_CONFIG
    from ieagan_torch.kernels.flash_attention import attention_bwd, attention_fwd
    from ieagan_torch.ops.diff_aug import sample_diff_aug_draws
    from ieagan_torch.train.step import make_train_step, restore_train_state

    t0 = time.perf_counter()
    state = restore_train_state(CHECKPOINT, "copy16000", device="cuda")
    cfg = {}  # the flagship config: DEFAULT_CONFIG, fused attention on
    print(f"restore copy16000: {time.perf_counter() - t0:.2f} s, itr {state.itr}", flush=True)
    es = state.G.event_size
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.rand((es, 256, 768, 1), generator=gen, device="cuda") * 2 - 1
    y = torch.randperm(es, generator=gen, device="cuda")
    draw_aug = lambda: sample_diff_aug_draws(gen, es, 256, 768, device="cuda")
    draw = lambda n: torch.randn((es, n), generator=gen, device="cuda")
    schedule = [draw(128), draw(4), draw_aug(), draw_aug(), draw(128), draw(4), draw_aug()]
    snap = lambda m: {k: v.clone() for k, v in m.state_dict().items()}
    G0, D0, E0 = snap(state.G), snap(state.D), snap(state.G_ema)
    sv_names = ["input_conv.sv", "attn_2.theta.sv", "RR_D.layers_0.self_attn.qkv_proj.sv",
                "linear1.sv"]
    torch.cuda.reset_peak_memory_stats()

    attention_fwd.launches = attention_bwd.launches = 0
    counts, times, mets = [], [], []
    for i in range(TRAIN_STEPS):
        step = (make_train_step(state.G, state.D, cfg, draw_schedule=schedule, capture_grads=True)
                if i == 0 else make_train_step(state.G, state.D, cfg))
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = step(state, x, y, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        counts.append((attention_fwd.launches - sum(c[0] for c in counts),
                       attention_bwd.launches - sum(c[1] for c in counts)))
        mets.append(m)
        if i == 0:
            G1, D1, E1 = snap(state.G), snap(state.D), snap(state.G_ema)
    launches = {"B1": attention_fwd.launches, "B2": attention_bwd.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, (m, ms, c) in enumerate(zip(mets, times, counts)):
        print(f"train step {i + 1}: {ms:.1f} ms, B1 {c[0]}, B2 {c[1]} launches, "
              + json.dumps({k: v for k, v in m.items() if not k.startswith("_")}), flush=True)
        if not all(np.isfinite(v) for k, v in m.items() if not k.startswith("_")):
            raise SystemExit(f"train step {i + 1}: non-finite metric")
        if c != (B1_PER_STEP, B2_PER_STEP):
            raise SystemExit(f"train step {i + 1}: B1/B2 launched {c}, expected "
                             f"{(B1_PER_STEP, B2_PER_STEP)}")
    steady = times[1:]
    print(f"train step: {sum(steady) / len(steady):.1f} ms per step, steady state (mean of "
          f"steps 2-{TRAIN_STEPS}, host clock after synchronize; step 1 {times[0]:.1f} ms); "
          f"peak device memory {peak:.2f} GiB", flush=True)

    grads = {**{f"G.{k}": v for k, v in mets[0]["_grads_G"].items()},
             **{f"D.{k}": v for k, v in mets[0]["_grads_D"].items()}}
    for name in ("G.RR_G.layers_0.self_attn.qkv_proj.weight", "G.linear_f.weight",
                 "D.attn_2.theta.weight", "D.RR_D.layers_0.self_attn.qkv_proj.weight"):
        norm = float(grads[name].norm())
        print(f"step 1 gradient norm {name}: {norm:.4e}", flush=True)
        if not norm > 0:
            raise SystemExit(f"{name}: no gradient reached it")
    for net, before, after, module in (("G", G0, G1, state.G), ("D", D0, D1, state.D)):
        lr, eps = DEFAULT_CONFIG[f"{net}_lr"], DEFAULT_CONFIG["adam_eps"]
        unchanged = {}
        for name, _ in module.named_parameters():
            if not torch.equal(after[name], before[name]):
                continue
            g = grads[f"{net}.{name}"].abs()
            # Adam's first step moves each entry by lr * |g| / (|g| + eps)
            if not bool(g.any()):
                reason = "exactly zero gradient"
            elif bool((lr * g / (g + eps) < before[name].abs() * 2.0 ** -24).all()):
                reason = "update below the weight's f32 resolution"
            else:
                raise SystemExit(f"{net}.{name} did not move though its gradient is "
                                 f"{float(g.norm()):.3e}")
            unchanged[reason] = unchanged.get(reason, 0) + 1
        total = sum(1 for _ in module.parameters())
        print(f"{net}: {total - sum(unchanged.values())} of {total} parameter leaves moved in "
              f"step 1; unchanged: {unchanged or 'none'}", flush=True)
    d = torch.tensor(0.9999, dtype=torch.float32, device="cuda")
    ema_err, ema_frac = 0.0, []
    for name, e1 in E1.items():
        want = E0[name] * d + G1[name] * (1 - d)
        ema_err = max(ema_err, float((e1 - want).abs().max()))
        delta = G1[name] - E0[name]
        big = 1e-4 * delta.abs() > 1e-5 * E0[name].abs()  # ~100 ulps of G_ema
        if bool(big.any()):
            ema_frac.append(float(((e1 - E0[name])[big] / delta[big]).median()))
    frac = float(np.median(ema_frac))
    print(f"G_ema after step 1: max |G_ema - (0.9999 G_ema0 + 1e-4 G)| = {ema_err:.3e}; "
          f"median fraction of the step's change taken: {frac:.6f} (expected 1e-4)", flush=True)
    if ema_err != 0.0 or not abs(frac - 1e-4) < 1e-5:
        raise SystemExit("G_ema did not take (1 - 0.9999) of the step's change")
    svs = {k: float(v[0]) for k, v in state.D.state_dict().items() if k in sv_names}
    print("D sv after the steps: " + json.dumps(svs) + " (before: "
          + json.dumps({k: float(D0[k][0]) for k in sv_names}) + ")", flush=True)
    if not all(np.isfinite(v) and v > 0 for v in svs.values()) or svs == {
            k: float(D0[k][0]) for k in sv_names}:
        raise SystemExit("spectral norms were not logged")
    fused_grads, fused_mets = grads, mets[0]
    del state, G0, D0, E0, G1, D1, E1, mets, grads
    torch.cuda.empty_cache()

    # The same first step again, with plain attention and then fused again:
    # the second says how far two runs of one program differ on the card
    # (cuDNN's backward kernels sum in no fixed order), the yardstick for
    # the first.
    for label, overrides in (("plain", {"use_pallas_attention": False}), ("fused again", {})):
        other = restore_train_state(CHECKPOINT, "copy16000", device="cuda", config=overrides)
        m = make_train_step(other.G, other.D, overrides, draw_schedule=schedule,
                            capture_grads=True)(other, x, y)
        other_grads = {**{f"G.{k}": v for k, v in m["_grads_G"].items()},
                       **{f"D.{k}": v for k, v in m["_grads_D"].items()}}
        errs = leaf_errors(np, fused_grads, other_grads)
        worst = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
        keys = [k for k in m if not k.startswith("_")]
        m_rel = max(abs(fused_mets[k] - m[k]) / max(abs(m[k]), 1e-12) for k in keys)
        m_ok = all(abs(fused_mets[k] - m[k]) <= STEP_METRIC_ATOL + STEP_METRIC_RTOL * abs(m[k])
                   for k in keys)
        med = float(np.median(list(errs.values())))
        print(f"fused vs {label} attention, one step from copy16000: metrics max rel diff "
              f"{m_rel:.3e}; gradient per-leaf normalized error max {max(errs.values()):.3e}, "
              f"median {med:.3e} over {len(errs)} leaves (tolerance max {STEP_GRAD_MAX}, "
              f"median {STEP_GRAD_MEDIAN}); worst {worst}", flush=True)
        if not (m_ok and max(errs.values()) < STEP_GRAD_MAX and med < STEP_GRAD_MEDIAN):
            raise SystemExit(f"the fused train step disagrees with the {label} step")
        del other, m, other_grads
        torch.cuda.empty_cache()
    return launches, sum(steady) / len(steady), peak


def golden_step_phase(torch, np):
    """Phase 6: the first step from copy16000 against the JAX package's."""
    from ieagan_torch.train import golden_step
    from ieagan_torch.train.step import make_train_step, restore_train_state

    g = golden_step.load()
    x, y, _ = golden_step.inputs(g["seed"])
    state = restore_train_state(CHECKPOINT, golden_step.CHECKPOINT_TAG, device="cuda")
    m = make_train_step(state.G, state.D, {}, draw_schedule=golden_step.draw_schedule(g),
                        capture_grads=True)(state, torch.tensor(x, device="cuda"),
                                            torch.tensor(y, device="cuda").long())
    grads = {net: {k: v.cpu().numpy() for k, v in m[f"_grads_{net}"].items()}
             for net in ("G", "D")}
    result = golden_step.compare(g, golden_step.summarize(m, grads, g["entries"]))
    print("golden step copy16000: " + json.dumps(result) + f" (tolerances: metrics rtol "
          f"{golden_step.METRIC_RTOL} atol {golden_step.METRIC_ATOL}, module gradient norms "
          f"rel {golden_step.NORM_RTOL}, entries {golden_step.ENTRY_RMS_TOL} of their "
          f"leaf's RMS)", flush=True)
    if not (result["metrics_ok"] and result["module_norm_ok"] and result["entries_ok"]):
        raise SystemExit("the card's train step disagrees with golden_step_copy16000.json")


def trace_summary(path, top=10):
    """From a Chrome trace of ``torch.profiler``: the ``top`` device kernels by
    total time (ms, calls), the traced window's length (ms) and the share of
    it in which no kernel, copy or memset ran on the device."""
    with open(path) as fp:
        events = [e for e in json.load(fp)["traceEvents"] if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not device:
        raise SystemExit(f"{path}: the trace holds no device event (CUPTI tracing failed)")
    totals = {}
    for e in device:
        if e["cat"] == "kernel":
            ms, n = totals.get(e["name"], (0.0, 0))
            totals[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    start = min(e["ts"] for e in events)
    end = max(e["ts"] + e["dur"] for e in events)
    busy, cursor = 0.0, start
    for e in sorted(device, key=lambda e: e["ts"]):
        lo, hi = max(e["ts"], cursor), e["ts"] + e["dur"]
        if hi > lo:
            busy += hi - lo
            cursor = hi
    ranked = sorted(totals.items(), key=lambda kv: -kv[1][0])[:top]
    return ranked, (end - start) / 1e3, 1.0 - busy / (end - start)


def write_png_tree(np, tree, cfg, events=2):
    """A PNG event tree in the reference layout: one dir per sensor, each
    event a 250x768 uint8 image with 1% of its pixels at 7-254 ADU (sparse
    as PXD data), from ``np.random.default_rng(3)``. Returns ``tree``."""
    from PIL import Image
    rng = np.random.default_rng(3)
    shape = (cfg["resolution"] - 6, cfg["resolution"] * cfg["H_base"])  # 250 x 768
    for s in range(cfg["n_classes"]):
        os.makedirs(os.path.join(tree, f"sensor_{s:02d}"))
        for e in range(events):
            img = np.where(rng.random(shape) < 0.01, rng.integers(7, 255, shape), 0)
            Image.fromarray(img.astype(np.uint8)).save(
                os.path.join(tree, f"sensor_{s:02d}", f"event_{e}.png"))
    return tree


def data_path(torch, np, driver, root, cfg):
    """Phase 7, dataset path: a PNG event tree in the reference layout
    (40 sensor dirs of 250x768 uint8 images, sparse as PXD data), loaded by
    the port's loader onto the card (pinned batches, copied on the loader's
    stream) and compared with its host batches; then two driver steps on it
    with the uint8 upload and the on-device transform."""
    from ieagan_torch.data import load_dataset
    from ieagan_torch.data.dataset import event_transform_stack
    from ieagan_torch.ops.image_norm import device_event_transform
    from ieagan_torch.utils.run_dirs import initialize_directories

    tree = write_png_tree(np, os.path.join(root, "pxd"), cfg)
    for raw in (False, True):
        loader = load_dataset(tree, num_workers=4, shuffle=True, seed=1, events_per_batch=1,
                              raw_uint8=raw)
        host = list(loader)
        loader.device = "cuda"
        loader.set_epoch(0)
        t = time.perf_counter()
        dev = list(loader)
        torch.cuda.synchronize()
        per_batch = (time.perf_counter() - t) / len(dev)
        if len(dev) != len(host) or not all(
                x.is_cuda and np.array_equal(x.cpu().numpy(), a)
                and np.array_equal(y.cpu().numpy(), b) for (x, y), (a, b) in zip(dev, host)):
            raise SystemExit(f"the loader's batches on the card differ from its host batches "
                             f"(raw_uint8={raw})")
        if raw:
            err = max(float((device_event_transform(x, None, 0.0).cpu()
                             - torch.from_numpy(event_transform_stack(a, None, 0.0))).abs().max())
                      for (x, _), (a, _) in zip(dev, host))
            if not err <= 2e-6:
                raise SystemExit(f"device_event_transform on the card: {err:.3e} from the host "
                                 "chain (bound 2e-6)")
        print(f"loader on the card (raw_uint8={raw}): {len(dev)} batches equal to the host's, "
              f"{per_batch * 1e3:.1f} ms per batch of {host[0][0].shape[0]} decoded images"
              + (f"; device transform within {err:.1e} of the host chain" if raw else ""),
              flush=True)
    dcfg = dict(cfg, outputroot=root, run_name="data", debug=False, dataroot=tree,
                device_transform=True, num_workers=4, save_every=10 ** 6)
    initialize_directories(dcfg)
    state, sd = driver.run(dcfg)
    if (state.itr, sd["epoch"]) != (2 // cfg["events_per_batch"], 1):
        raise SystemExit(f"dataset run: itr {state.itr}, state_dict {sd}")
    print(f"dataset run: {state.itr} steps over the PNG tree with the uint8 upload and the "
          "on-device transform", flush=True)


def driver_phase(torch, np):
    """Phase 7: the training entry point as a user runs it (bf16 policy)."""
    import tempfile
    import ieagan_torch.kernels.flash_attention as fa
    import ieagan_torch.train.driver as driver
    from ieagan_torch.core.config import DEFAULT_CONFIG
    from ieagan_torch.models.convert import (discriminator_state_to_flax,
                                             generator_state_to_flax, optimizer_state_to_flax)
    from ieagan_torch.utils.flax_msgpack import read_checkpoint
    from ieagan_torch.utils.run_dirs import initialize_directories

    def trees(state):
        return {"G": generator_state_to_flax(state.G), "D": discriminator_state_to_flax(state.D),
                "G_ema": generator_state_to_flax(state.G_ema),
                "G_optim": optimizer_state_to_flax(state.opt_G, state.G),
                "D_optim": optimizer_state_to_flax(state.opt_D, state.D)}

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", np.asarray(v)

    def bit_equal(weights_dir, tag, want):
        """Every leaf of every component of ``tag`` equal to ``want``'s."""
        n = 0
        for base, tree in want.items():
            got = dict(flat(read_checkpoint(os.path.join(weights_dir, f"{base}_{tag}.msgpack"))))
            exp = dict(flat(tree))
            if got.keys() != exp.keys():
                raise SystemExit(f"{base}_{tag}: leaves differ from the state's")
            for k, v in exp.items():
                if got[k].dtype != v.dtype or got[k].shape != v.shape or not np.array_equal(
                        got[k], v):
                    raise SystemExit(f"{base}_{tag}: leaf {k} differs from the state's")
            n += len(exp)
        return n

    # Observation only: the step, the checkpoint writer and the fused
    # attention's autograd function are wrapped to record per-step launches,
    # times and the kernels' input types.
    steps, saves, dtypes, snaps = [], [], set(), {}
    make_step, save_ckpt = driver.make_train_step, driver.save_checkpoint
    fwd, bwd = fa.attention_fwd, fa.attention_bwd

    def counted_make_train_step(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def counted(state, x, y, generator=None):
            snapshots = "data run" not in snaps
            if state.itr == 4 and snapshots:  # the resumed run's state, loaded from copy4
                snaps["loaded4"] = trees(state)
            b1, b2 = fwd.launches, bwd.launches
            torch.cuda.synchronize()
            t = time.perf_counter()
            m = step(state, x, y, generator)
            torch.cuda.synchronize()
            steps.append({"itr": state.itr, "ms": (time.perf_counter() - t) * 1e3,
                          "B1": fwd.launches - b1, "B2": bwd.launches - b2,
                          **{k: v for k, v in m.items() if not k.startswith("_")}})
            if state.itr == 2 and snapshots:
                snaps["after2"] = trees(state)
            return m
        return counted

    def timed_save(*args, **kwargs):
        t = time.perf_counter()
        save_ckpt(*args, **kwargs)
        saves.append(time.perf_counter() - t)

    flash_fwd, flash_bwd = fa.FlashAttention.forward, fa.FlashAttention.backward

    def seen_fwd(ctx, q, *args):
        dtypes.add(str(q.dtype))
        return flash_fwd(ctx, q, *args)

    def seen_bwd(ctx, do):
        dtypes.add(str(do.dtype))
        return flash_bwd(ctx, do)

    driver.make_train_step, driver.save_checkpoint = counted_make_train_step, timed_save
    fa.FlashAttention.forward, fa.FlashAttention.backward = (staticmethod(seen_fwd),
                                                             staticmethod(seen_bwd))
    try:
        with tempfile.TemporaryDirectory() as root:
            # the first run is untraced; the resume traces steps 5 and 6
            cfg = dict(DEFAULT_CONFIG, outputroot=root, run_name="smoke", **DRIVER_RUN)
            initialize_directories(cfg)
            torch.cuda.reset_peak_memory_stats()
            fwd.launches = bwd.launches = 0
            t0 = time.perf_counter()
            state, sd = driver.run(cfg)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = {"B1": fwd.launches, "B2": bwd.launches}
            peak = torch.cuda.max_memory_allocated() / 2**30
            weights = os.path.join(root, "smoke", "weights")
            n2 = bit_equal(weights, "copy2", snaps.pop("after2"))
            final4 = trees(state)
            n4 = bit_equal(weights, "copy4", final4)
            if (state.itr, sd["itr"], sd["epoch"], state.opt_G.count, state.opt_D.sched_count) \
                    != (4, 4, 1, 4, 4):
                raise SystemExit(f"driver run: itr {state.itr}, state_dict {sd}, counts "
                                 f"{state.opt_G.count}/{state.opt_D.sched_count}")
            files = set()
            for dirpath, _, names in os.walk(os.path.join(root, "smoke")):
                files |= {os.path.relpath(os.path.join(dirpath, n), os.path.join(root, "smoke"))
                          for n in names}
            n_sv = sum(1 for m in (state.G, state.D) for k, _ in m.named_buffers()
                       if k.endswith(".sv"))
            try:
                import matplotlib  # noqa: F401
                heatmaps = True
            except ImportError:
                heatmaps = False
            expected = {f"logs/{m}.log" for m in DRIVER_METRICS + ("sec_per_itr",)}
            expected |= {"logs/metalog.txt"}
            for itr in (2, 4):
                expected |= {f"weights/{b}_copy{itr}.msgpack"
                             for b in ("G", "D", "G_optim", "D_optim", "G_ema")}
                expected |= {f"weights/state_dict_copy{itr}.json",
                             f"samples/fixed_samples{itr}.jpg", f"samples/sample_sheet{itr}.jpg"}
                if heatmaps:
                    expected |= {f"samples/sim_heatmap_G{itr}.jpg",
                                 f"samples/sim_heatmap_D{itr}.jpg"}
            sv_logs = {f for f in files if f.startswith("logs/") and f.endswith("_sv.log")}
            config_copies = {f for f in files if "/" not in f and f.endswith("_config.json")}
            rest = files - sv_logs - config_copies
            if rest != expected or len(sv_logs) != n_sv or len(config_copies) != 1:
                raise SystemExit(f"run dir: unexpected {sorted(rest - expected)}, missing "
                                 f"{sorted(expected - rest)}, {len(sv_logs)} sv logs for {n_sv} "
                                 f"spectral-norm layers")
            print(f"driver run: {run_s:.1f} s for 4 steps and 3 saves, run dir as the JAX "
                  f"driver writes it ({len(files)} files, {len(sv_logs)} sv logs"
                  + ("" if heatmaps else "; no matplotlib here, so no similarity heatmaps")
                  + f"); copy2 and copy4 read back bit-equal ({n2} and {n4} leaves)", flush=True)
            del state

            rcfg = dict(cfg, resume=True, num_epochs=2, stop_after=6,
                        trace_dir=os.path.join(root, "trace"))
            fwd.launches = bwd.launches = 0
            state, sd = driver.run(rcfg)
            torch.cuda.synchronize()
            launches = {k: launches[k] + v for k, v in
                        (("B1", fwd.launches), ("B2", bwd.launches))}
            bit_equal(weights, "copy4", snaps.pop("loaded4"))
            if (state.itr, sd["itr"], sd["epoch"], state.opt_G.count, state.opt_G.sched_count,
                    state.opt_D.count) != (6, 6, 2, 6, 6, 6):
                raise SystemExit(f"resume: itr {state.itr}, state_dict {sd}, counts "
                                 f"{state.opt_G.count}/{state.opt_G.sched_count}/"
                                 f"{state.opt_D.count}")
            print(f"resume from copy4: itr {state.itr}, epoch {sd['epoch']}, Adam counts "
                  f"G {state.opt_G.count} D {state.opt_D.count}; copy4 as loaded equals the "
                  "state the first run saved", flush=True)
            trace = os.path.join(root, "trace", "trace_itr5.json")
            ranked, window_ms, idle = trace_summary(trace)
            print(f"trace of steps 5-6: window {window_ms:.1f} ms, device idle share "
                  f"{idle:.4f}; top device kernels (total ms, calls): " + json.dumps(
                      [(name[:90], round(ms, 3), n) for name, (ms, n) in ranked]), flush=True)
            del state
            snaps["data run"] = True
            data_path(torch, np, driver, root, dict(DEFAULT_CONFIG, **DRIVER_RUN))
    finally:
        driver.make_train_step, driver.save_checkpoint = make_step, save_ckpt
        fa.FlashAttention.forward = staticmethod(flash_fwd)
        fa.FlashAttention.backward = staticmethod(flash_bwd)
        torch.cuda.empty_cache()

    for s in steps:
        print("driver step " + json.dumps(s), flush=True)
        if not all(np.isfinite(s[k]) for k in DRIVER_METRICS):
            raise SystemExit(f"driver step {s['itr']}: non-finite metric")
        if (s["B1"], s["B2"]) != (B1_PER_STEP, B2_PER_STEP):
            raise SystemExit(f"driver step {s['itr']}: B1/B2 launched {s['B1']}/{s['B2']}, "
                             f"expected {B1_PER_STEP}/{B2_PER_STEP}")
    if [s["itr"] for s in steps] != [1, 2, 3, 4, 5, 6] + list(range(1, len(steps) - 5)):
        raise SystemExit(f"driver steps {[s['itr'] for s in steps]}")
    if dtypes != {"torch.bfloat16"}:
        raise SystemExit(f"the attention kernels took {dtypes} on the bf16 driver path")
    steady = [s["ms"] for s in steps[1:4]]
    step_ms = sum(steady) / len(steady)
    print(f"driver bf16 step: {step_ms:.1f} ms per step (mean of steps 2-4, host clock "
          f"after synchronize; step 1 {steps[0]['ms']:.1f} ms); peak device memory "
          f"{peak:.2f} GiB; checkpoint save {np.median(saves):.2f} s (median of {len(saves)}); "
          f"B1/B2 launches {launches['B1']}/{launches['B2']} in the two runs, all bf16",
          flush=True)
    return launches, step_ms, peak


def step_gap(torch, np, a, b):
    """What separates the step ``a`` from the step ``b`` (metrics with
    ``_grads_G``/``_grads_D``): the six metrics of both and the largest
    |a - b| / |b|, and per network the largest relative gap of a module's
    gradient norm (module: the name's first part) and the median of the
    gradients' per-leaf cosines over leaves whose gradient in ``b`` is not
    null (norm >= 1e-5: conv biases feeding batch norms), with the three
    least."""
    out = {"metrics": {k: [a[k], b[k]] for k in DRIVER_METRICS},
           "metric_rel": max(abs(a[k] - b[k]) / abs(b[k]) for k in DRIVER_METRICS
                             if b[k] != 0)}
    for net in ("G", "D"):
        ga, gb = a[f"_grads_{net}"], b[f"_grads_{net}"]
        sq_a, sq_b, cos = {}, {}, {}
        for name, vb in gb.items():
            va, vb = ga[name].double().flatten(), vb.double().flatten()
            top = name.split(".")[0]
            na, nb = float(va.norm()), float(vb.norm())
            sq_a[top] = sq_a.get(top, 0.0) + na * na
            sq_b[top] = sq_b.get(top, 0.0) + nb * nb
            if nb >= 1e-5:
                cos[name] = float(va @ vb) / max(na * nb, 1e-30)
        out[f"{net}_norm_rel"] = float(max(abs(np.sqrt(sq_a[k]) - np.sqrt(v)) / np.sqrt(v)
                                           for k, v in sq_b.items() if v > 0))
        out[f"{net}_cos_median"] = float(np.median(list(cos.values())))
        out[f"{net}_cos_least"] = sorted(cos.items(), key=lambda kv: kv[1])[:3]
    return out


def gap_breaks(gap):
    """The bounds of phase 8 (BF16_CHECKS) that the pair ``gap`` breaks."""
    a_b = gap["metrics"].values()
    checks = {"metrics": all(abs(a - b) <= BF16_METRIC_RTOL * abs(b) + BF16_METRIC_ATOL
                             for a, b in a_b)}
    checks["D norms"] = gap["D_norm_rel"] <= BF16_D_NORM_RTOL
    for net in ("G", "D"):
        checks[f"{net} cosine"] = gap[f"{net}_cos_median"] >= BF16_COS_MEDIAN_MIN[net]
    return [k for k in BF16_CHECKS if not checks[k]]


def phase8_inputs(torch, es=40):
    """Phase 8's reals (uniform in [-1, 1]) and labels, one event."""
    gen = torch.Generator(device="cuda").manual_seed(BF16_SEEDS[0])
    x = torch.rand((es, 256, 768, 1), generator=gen, device="cuda") * 2 - 1
    return x, torch.randperm(es, generator=gen, device="cuda")


def phase8_draws(torch, seed, es=40):
    """A draw schedule of one step: the fakes' DiffAugment draws at bf16's
    granularity (exact in f32 as well), the reals' in f32."""
    from ieagan_torch.ops.diff_aug import sample_diff_aug_draws

    gen = torch.Generator(device="cuda").manual_seed(1000 + seed)
    draw = lambda n: torch.randn((es, n), generator=gen, device="cuda")
    aug = lambda dtype: sample_diff_aug_draws(gen, es, 256, 768, device="cuda", dtype=dtype)
    return [draw(128), draw(4), aug(torch.bfloat16), aug(torch.float32), draw(128), draw(4),
            aug(torch.bfloat16)]


def phase8_step(torch, np, x, y, schedule, dtype, cfg):
    """One step from copy16000 in ``dtype`` with ``cfg``, gradients captured."""
    from ieagan_torch.train.step import make_train_step, restore_train_state

    state = restore_train_state(CHECKPOINT, "copy16000", config=cfg, device="cuda",
                                compute_dtype=dtype)
    m = make_train_step(state.G, state.D, cfg, draw_schedule=schedule,
                        capture_grads=True)(state, x, y)
    if not all(np.isfinite(m[k]) for k in DRIVER_METRICS):
        raise SystemExit(f"the {dtype} step: non-finite metric")
    del state
    torch.cuda.empty_cache()
    return m


def bf16_vs_f32_phase(torch, np):
    """Phase 8: one step from copy16000 under each policy, per seed of draws;
    each bf16 step against the f32 step on its own draws and on another
    seed's."""
    x, y = phase8_inputs(torch)
    steps = {}
    for seed in BF16_SEEDS:
        schedule = phase8_draws(torch, seed)
        for dtype in (torch.bfloat16, torch.float32):
            steps[(seed, dtype)] = phase8_step(torch, np, x, y, schedule, dtype, {})
    faults = []
    for s_b16 in BF16_SEEDS:
        for s_f32 in BF16_SEEDS:
            gap = step_gap(torch, np, steps[(s_b16, torch.bfloat16)],
                           steps[(s_f32, torch.float32)])
            broken = gap_breaks(gap)
            sound = s_b16 == s_f32
            print(f"bf16 step on draws {s_b16} vs f32 step on draws {s_f32} "
                  f"({'sound' if sound else 'control'}): " + json.dumps(gap)
                  + f"; breaks {broken}", flush=True)
            if sound and broken:
                faults.append(f"the bf16 step on draws {s_b16} breaks {broken}")
            kept = sorted(set(BF16_CHECKS) - set(broken))
            if not sound and kept:
                faults.append(f"the control {s_b16}/{s_f32} keeps {kept}")
    # Yardsticks on the first draws, printed: how far rounding in the f32
    # step's convolutions and matmuls alone (TF32, 8x finer than bf16) moves
    # it, and the bf16 step against the f32 step with D left unchanged by
    # its update (D_lr 0), so that G's gradient is taken through the same D.
    first = BF16_SEEDS[0]
    schedule = phase8_draws(torch, first)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = phase8_step(torch, np, x, y, schedule, torch.float32, {})
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    print("yardstick, f32 step with TF32 vs f32 step on draws %d: " % first + json.dumps(
        step_gap(torch, np, tf32, steps[(first, torch.float32)])), flush=True)
    frozen = {"D_lr": 0.0}
    print("yardstick, bf16 vs f32 step with D_lr 0 on draws %d: " % first + json.dumps(
        step_gap(torch, np, phase8_step(torch, np, x, y, schedule, torch.bfloat16, frozen),
                 phase8_step(torch, np, x, y, schedule, torch.float32, frozen))), flush=True)
    print(f"phase 8 bounds: metrics |bf16 - f32| <= {BF16_METRIC_RTOL} |f32| + "
          f"{BF16_METRIC_ATOL}; D module gradient norms rel {BF16_D_NORM_RTOL}; per-leaf "
          f"cosine median G >= {BF16_COS_MEDIAN_MIN['G']}, D >= {BF16_COS_MEDIAN_MIN['D']}",
          flush=True)
    if faults:
        raise SystemExit("phase 8: " + "; ".join(faults))


def inception_parity(torch, np):
    """Phase 9a: the port's Inception with the fallback weights against the
    JAX package's features in ``golden_inception.json``; the control (the
    other half of the images) must break the bounds. Times per image at one
    event's batch, TF32 off and on."""
    from ieagan_torch.eval import golden
    from ieagan_torch.eval.fid import FeatureExtractor, f32_products
    from ieagan_torch.eval.inception import build_inception, init_feature_weights

    g = golden.load()
    extractor = FeatureExtractor(device="cuda", seed=g["seed"])
    feats = extractor(torch.tensor(golden.inputs(g["seed"]), device="cuda"))
    half = golden.N_IMAGES // 2
    result = golden.compare(g, feats)
    control = golden.compare(g, feats[half:], images=np.arange(half))
    print(f"inception vs golden_inception.json: {json.dumps(result)}; control (other half of "
          f"the images): {json.dumps(control)} (bounds: norm {golden.NORM_RTOL}, entries "
          f"{golden.ENTRY_RTOL} of the image's norm)", flush=True)
    if not (result["norm_ok"] and result["entry_ok"]):
        raise SystemExit("the card's Inception features disagree with golden_inception.json")
    if control["norm_ok"] or control["entry_ok"]:
        raise SystemExit("the Inception control kept a bound: the bounds cannot tell images apart")
    model = build_inception(init_feature_weights(0), "cuda")
    x = torch.rand((40, 3, 299, 299), device="cuda")
    macs = []  # per image: each convolution's outputs times its kernel's inputs
    hooks = [m.register_forward_hook(lambda m, i, o: macs.append(
        o[0].numel() * m.weight[0].numel())) for m in model.modules()
        if isinstance(m, torch.nn.Conv2d)]
    with torch.inference_mode():
        model(x[:1])
    for h in hooks:
        h.remove()
    gflop = 2 * sum(macs) / 1e9
    per_image = {}
    for label, tf32 in (("f32", False), ("tf32", True)):
        with f32_products(), torch.inference_mode():
            torch.backends.cudnn.allow_tf32 = tf32
            per_image[label] = time_ms(torch, lambda: model(x), reps=5, inner=1) / x.shape[0]
    print(f"inception forward at 40 images ({gflop:.3f} GFLOP of convolutions per image): "
          f"{per_image['f32']:.3f} ms per image in f32 with TF32 off "
          f"({gflop / per_image['f32']:.1f} TFLOP/s), {per_image['tf32']:.3f} with TF32 "
          f"({gflop / per_image['tf32']:.1f} TFLOP/s, printed only)", flush=True)
    return per_image


def resize_parity(torch, np, model):
    """Phase 9b: the device resize of the golden event's 40 images against
    PIL's on the host, within ``tests/test_eval.py``'s bounds."""
    from ieagan_torch.deploy import golden
    from ieagan_torch.eval.fid import fid_postprocess
    from ieagan_torch.eval.resize import pil_resize_batch, resize_single_channel

    z, rdof = (torch.tensor(a, device="cuda") for a in golden.inputs(golden.load()["seed"]))
    with torch.inference_mode():
        imgs01 = fid_postprocess(model.G(z, model.labels(1), rdof).float())
        dev = resize_single_channel(imgs01).cpu().numpy()
    err = np.abs(dev - pil_resize_batch(imgs01.cpu().numpy()))
    print(f"resize of the best0 golden event {tuple(imgs01.shape)} -> {dev.shape}: vs PIL max "
          f"{err.max():.3e}, mean {err.mean():.3e} (bounds 5e-3, 2e-4)", flush=True)
    if not (err.max() < 5e-3 and err.mean() < 2e-4):
        raise SystemExit("the device resize disagrees with PIL's")


def fid_machinery(torch, np, model, tree, fwd):
    """Phase 9c: 50 best0 events (2,000 images) through ``make_generator_fn``
    (trunc 1, permuted labels): features, device moments against host f64
    ``np.cov``, FID and KID against stats minted from the PNG tree, and the
    self-check (stats minted from a feature set score it ~0, the set shifted
    scores higher). Returns B1's launches per generator call and times."""
    from ieagan_torch.eval import fid

    cfg = dict(model.config, fid_dataset_name="pngtree")
    extractor = fid.FeatureExtractor(device="cuda")
    t = time.perf_counter()
    fid.make_custom_stats("pngtree", tree, extractor=extractor)
    fid.make_custom_kid_stats("pngtree", tree, extractor=extractor)
    mint_s = time.perf_counter() - t
    n_gen, chunks = 2000, 10
    gen = fid.make_generator_fn(model.G, cfg, trunc=1.0, chunks=chunks)
    seeded = lambda: torch.Generator(device="cuda").manual_seed(8)
    fwd.launches = 0
    calls = 0

    def counted(generator):
        nonlocal calls
        calls += 1
        return gen(generator)

    torch.cuda.synchronize()
    t = time.perf_counter()
    fid_best0, feats = fid.compute_fid(counted, dataset_name="pngtree", num_gen=n_gen,
                                       generator=seeded(), extractor=extractor,
                                       return_features=True)
    fid_s = time.perf_counter() - t
    b1_per_call = fwd.launches // calls
    if fwd.launches != calls * chunks:
        raise SystemExit(f"B1 launched {fwd.launches} times in {calls} FID generator calls of "
                         f"{chunks} chunks")
    if feats.shape != (n_gen, 2048) or not np.isfinite(feats).all():
        raise SystemExit(f"FID features: shape {feats.shape}, finite {np.isfinite(feats).all()}")
    torch.cuda.synchronize()
    t = time.perf_counter()
    mu, sigma, n = fid.get_model_features(gen, extractor, num_gen=n_gen, generator=seeded(),
                                          return_moments=True)
    torch.cuda.synchronize()
    features_s = time.perf_counter() - t
    host = feats.astype(np.float64)
    cov = np.cov(host, rowvar=False)
    mu_err = float(np.abs(mu - host.mean(0)).max() / np.abs(host).max())
    sigma_rel = float(np.linalg.norm(sigma - cov) / np.linalg.norm(cov))
    print(f"device moments of {n} best0 images vs host f64 np.cov: mu {mu_err:.3e} of the "
          f"largest feature, sigma {sigma_rel:.3e} relative (bounds 1e-5, 1e-4)", flush=True)
    if not (n == n_gen and mu_err < 1e-5 and sigma_rel < 1e-4):
        raise SystemExit("the device moments disagree with the host covariance")
    ref_kid = np.load(fid._stats_path("pngtree").replace(".npz", "_kid.npz"))["feats"]
    kid = fid.kernel_distance(feats, ref_kid, seed=0)
    kid_floor = fid.kid_self_floor(ref_kid, seed=0)
    t = time.perf_counter()
    self_fid = fid.frechet_distance(host.mean(0), cov, host.mean(0), cov)
    sqrtm_s = time.perf_counter() - t
    shift = 0.05 * host.std(0)
    shift_fid = fid.frechet_distance(host.mean(0) + shift, cov, host.mean(0), cov)
    print(f"best0 vs the PNG tree's stats ({len(ref_kid)} images, fallback Inception): FID "
          f"{fid_best0:.4f}, KID {kid:.4e} (real-vs-real floor {kid_floor:.4e}); self-check: "
          f"FID of the set against itself {self_fid:.3e}, shifted by 0.05 std {shift_fid:.4e} "
          f"(|shift|^2 = {float(shift @ shift):.4e})", flush=True)
    if not (np.isfinite(fid_best0) and fid_best0 > 0 and np.isfinite(kid)):
        raise SystemExit("FID/KID of best0 not finite and positive")
    if not (abs(self_fid) < 1e-3 * np.trace(cov) and shift_fid > abs(self_fid)
            and abs(shift_fid - float(shift @ shift)) < 0.05 * float(shift @ shift)):
        raise SystemExit("the FID self-check failed")
    extrapolated = 8 * (fid_s - sqrtm_s) + sqrtm_s
    print(f"FID of {n_gen} images: {fid_s:.2f} s (generation, resize, Inception, host f64 "
          f"sqrtm {sqrtm_s:.2f} s); features alone {features_s:.2f} s; 16,000 images (the "
          f"default) extrapolated {extrapolated:.1f} s; stats minted from {len(ref_kid)} PNGs "
          f"in {mint_s:.2f} s; B1 {b1_per_call} launches per generator call of {chunks} chunks, "
          f"{fwd.launches} in {calls} calls", flush=True)
    return {"b1_per_call": b1_per_call, "fid_s": fid_s, "sqrtm_s": sqrtm_s,
            "fid16000_s": extrapolated}


def driver_fid_phase(torch, np, root):
    """Phase 9d: ``train/driver.py::run`` at the flagship width reaching
    ``test_every`` once with the FID subprocess and once in process (400
    images against the minted stats): FID finite and logged, best0 written,
    ``best_FID`` in the state dict, the subprocess's JSON line read."""
    import ieagan_torch.train.driver as driver
    from ieagan_torch.core.config import DEFAULT_CONFIG
    from ieagan_torch.utils.run_dirs import initialize_directories

    results = []
    sub = driver._run_fid_subprocess

    def recorded(*args, **kwargs):
        res = sub(*args, **kwargs)
        results.append(res)
        return res

    driver._run_fid_subprocess = recorded
    try:
        for subprocess_on in (True, False):
            name = "fid_sub" if subprocess_on else "fid_inproc"
            cfg = dict(DEFAULT_CONFIG, outputroot=root, run_name=name, debug=True,
                       debug_batches=1, num_epochs=1, save_every=1, test_every=1,
                       samples_per_class_sheet=0, fid_subprocess=subprocess_on,
                       num_incep_images=400, fid_gen_chunks=5, fid_dataset_name="pngtree")
            initialize_directories(cfg)
            t = time.perf_counter()
            state, sd = driver.run(cfg)
            run_s = time.perf_counter() - t
            logs = [json.loads(ln) for ln in open(os.path.join(
                root, name, "logs", "metric_log.jsonl"))]
            fids = [r["FID"] for r in logs if "FID" in r]
            weights = os.path.join(root, name, "weights")
            best = json.load(open(os.path.join(weights, "state_dict_best0.json")))
            print(f"driver run ({'subprocess' if subprocess_on else 'in process'} FID): "
                  f"{run_s:.1f} s for one step, one save and one test; FID {fids}, best_FID "
                  f"{sd['best_FID']}, best0 {best['best_FID']}", flush=True)
            if not (len(fids) == 1 and np.isfinite(fids[0]) and fids[0] >= 0
                    and sd["best_FID"] == fids[0] == best["best_FID"]
                    and os.path.exists(os.path.join(weights, "G_ema_best0.msgpack"))):
                raise SystemExit(f"the driver's FID test ({name}) was not logged and tracked")
            del state
            torch.cuda.empty_cache()
    finally:
        driver._run_fid_subprocess = sub
    if len(results) != 1 or not isinstance(results[0], dict) or not (
            {"fid", "nonzero_frac", "tag"} <= set(results[0])):
        raise SystemExit(f"the FID subprocess's JSON line: {results}")
    print(f"FID subprocess JSON line: {json.dumps(results[0])}", flush=True)


def producer_phase(torch, np, model):
    """Phase 9e: ``EventProducer`` from best0, 8 events at 4 per call: each
    event's digits are its block's ADU > 0 pixels with their uint8-truncated
    charges; the golden event's per-sensor digit counts within the golden
    file's nonzero bound; events per second and ms of extraction per event."""
    from ieagan_torch.deploy import golden
    from ieagan_torch.deploy import producer as prod

    producer = prod.EventProducer(model, num_events=8, events_per_call=4, chunks=1, seed=9)
    blocks = []
    generate = producer._generate

    def recorded(generator):  # observation only: keep each block the thread generates
        block = generate(generator)
        blocks.append(block.cpu().numpy())
        return block

    producer._generate = recorded
    torch.cuda.synchronize()
    t = time.perf_counter()
    events = list(producer.start())
    wall = time.perf_counter() - t
    producer.join(timeout=60)
    es = model.event_size
    flat = np.concatenate(blocks)
    if len(events) != 8 or len(blocks) != 2:
        raise SystemExit(f"producer: {len(events)} events from {len(blocks)} blocks")
    for e, (coords, charges) in enumerate(events):
        imgs = flat[e * es:(e + 1) * es]
        want_coords, want_charges = prod.extract_sparse_digits_plain(imgs)
        if not (len(coords) == int((imgs > 0).sum()) and np.array_equal(coords, want_coords)
                and np.array_equal(charges, want_charges)):
            raise SystemExit(f"producer event {e}: digits differ from its block's pixels")
    g = golden.load()
    z, rdof = (torch.tensor(a, device="cuda") for a in golden.inputs(g["seed"]))
    event = model.events(z, rdof).cpu().numpy()
    t = time.perf_counter()
    coords, _ = prod.extract_sparse_digits(event)
    extract_ms = (time.perf_counter() - t) * 1e3
    counts = np.bincount(coords[:, 0], minlength=es)
    worst = int(np.abs(counts - np.asarray(g["nonzero"])).max())
    print(f"producer: 8 events in {wall:.2f} s ({8 / wall:.2f} events/s, 2 blocks of 4), every "
          f"event's digits equal its block's; golden event's per-sensor digit counts within "
          f"{worst} of golden_best0.json's nonzero counts (bound {golden.NONZERO_ATOL}); "
          f"extraction {extract_ms:.2f} ms per event ({len(coords)} digits)", flush=True)
    if worst > golden.NONZERO_ATOL:
        raise SystemExit("the producer's digits of the golden event disagree with its counts")
    return 8 / wall, extract_ms


def physics_phase(torch, np, model):
    """Phase 9f: ``generate_stats`` (device reductions) against
    ``get_stats(generate_event_stream(...))`` on the same seed, 8 events."""
    from ieagan_torch.eval import physics

    cfg = model.config
    t = time.perf_counter()
    dev = physics.generate_stats(model.G, cfg, n_events=8, seed=4, events_per_call=4)
    dev_s = time.perf_counter() - t
    t = time.perf_counter()
    host = physics.get_stats(physics.generate_event_stream(model.G, cfg, seed=4,
                                                           events_per_call=4), n_events=8)
    host_s = time.perf_counter() - t
    same = all(np.array_equal(dev[k], host[k]) for k in ("intensity_hist", "occupancy_hist",
                                                         "per_sensor_occupancy"))
    charge = np.nanmax(np.abs(dev["per_sensor_mean_charge"] - host["per_sensor_mean_charge"])
                       / np.abs(host["per_sensor_mean_charge"]))
    print(f"physics over 8 best0 events: device reductions {dev_s:.2f} s, host path "
          f"{host_s:.2f} s; histograms and occupancies equal: {same}; mean charge within "
          f"{charge:.3e} relative (bound 1e-5); mean occupancy "
          f"{float(np.mean(dev['per_sensor_occupancy'])):.5f}", flush=True)
    if not (same and charge <= 1e-5 and dev["n_events"] == host["n_events"] == 8):
        raise SystemExit("generate_stats disagrees with the host path")


def eval_phase(torch, np):
    """Phase 9: FID/KID and physics evaluation, and the event producer."""
    import tempfile
    from ieagan_torch.core.config import DEFAULT_CONFIG
    from ieagan_torch.deploy import Model
    from ieagan_torch.kernels.flash_attention import attention_fwd

    out = {}
    t0 = time.perf_counter()
    out["inception_ms"] = inception_parity(torch, np)
    phase("eval: inception", t0)
    model = Model.restore(CHECKPOINT, tag="best0", device="cuda")
    t0 = time.perf_counter()
    resize_parity(torch, np, model)
    phase("eval: resize", t0)
    stats_env = os.environ.get("IEAGAN_STATS_DIR")
    with tempfile.TemporaryDirectory() as root:
        os.environ["IEAGAN_STATS_DIR"] = os.path.join(root, "stats")
        try:
            tree = write_png_tree(np, os.path.join(root, "pxd"), DEFAULT_CONFIG)
            t0 = time.perf_counter()
            out.update(fid_machinery(torch, np, model, tree, attention_fwd))
            phase("eval: FID machinery", t0)
            t0 = time.perf_counter()
            driver_fid_phase(torch, np, root)
            phase("eval: driver test_every", t0)
        finally:
            if stats_env is None:
                os.environ.pop("IEAGAN_STATS_DIR", None)
            else:
                os.environ["IEAGAN_STATS_DIR"] = stats_env
    t0 = time.perf_counter()
    out["events_per_s"], out["extract_ms"] = producer_phase(torch, np, model)
    phase("eval: producer", t0)
    t0 = time.perf_counter()
    physics_phase(torch, np, model)
    phase("eval: physics", t0)
    return out


def main():
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, ROOT)
    from ieagan_torch.kernels import build, selfcheck
    from ieagan_torch.kernels.flash_attention import (
        attention_bwd, attention_bwd_plain, attention_fwd, attention_fwd_plain)

    smi = nvidia_smi()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"nvidia-smi: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    phase("device", t0)

    t0 = time.perf_counter()
    from concurrent.futures import ThreadPoolExecutor
    from ieagan_torch.deploy import producer
    with ThreadPoolExecutor(1) as pool:  # the host library builds beside nvcc
        host_lib = pool.submit(producer.build_native)
        for name, res in build.build().items():
            print(f"built {name} in {res['seconds']:.2f} s -> "
                  f"{os.path.relpath(res['path'], ROOT)}", flush=True)
            for ln in ptxas_summary(res["log"]):
                print(f"  {ln}", flush=True)
        res = host_lib.result()
    print(f"built sparse_digits (g++) in {res['seconds']:.2f} s -> "
          f"{os.path.relpath(res['path'], ROOT)}", flush=True)
    phase("build", t0)

    t0 = time.perf_counter()
    rows = kernel_vs_plain(torch, attention_fwd, attention_fwd_plain)
    phase("kernel vs plain", t0)

    t0 = time.perf_counter()
    bwd_rows = backward_vs_plain(torch, attention_fwd, attention_bwd, attention_bwd_plain)
    phase("backward kernel vs plain", t0)

    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        print(f"selfcheck {dtype}: " + json.dumps(selfcheck.run_check(dtype)), flush=True)
    phase("selfcheck", t0)

    t0 = time.perf_counter()
    deploy_launches = main_path(torch, np)
    phase("deployment path", t0)

    t0 = time.perf_counter()
    train_launches, step_ms, peak = train_path(torch, np)
    phase("training path", t0)

    t0 = time.perf_counter()
    golden_step_phase(torch, np)
    phase("golden step", t0)

    t0 = time.perf_counter()
    driver_launches, driver_ms, driver_peak = driver_phase(torch, np)
    phase("training entry point", t0)

    t0 = time.perf_counter()
    bf16_vs_f32_phase(torch, np)
    phase("bf16 vs f32", t0)

    t0 = time.perf_counter()
    ev = eval_phase(torch, np)
    phase("evaluation and producer", t0)

    # The heaviest site on the training path: D's image attention at 40 images.
    pick = lambda rs: next(r for r in rs if r["site"] == "D_SA" and r["shape"][0] == 40
                           and r["dtype"] == "float32")
    b1, b2 = pick(rows), pick(bwd_rows)
    # the same site in bf16, the type the driver path runs it in
    pick16 = lambda rs: next(r for r in rs if r["site"] == "D_SA" and r["shape"][0] == 40
                             and r["dtype"] == "bfloat16")
    b1h, b2h = pick16(rows), pick16(bwd_rows)
    kernels = [{
        "name": "attention_fwd (B1)", "route": "cuda",
        "source": "ieagan_torch/kernels/csrc/attention_fwd.cu",
        "replaces": "ieagan_tpu/ops/pallas/flash_attention.py:63",
        "launches": train_launches["B1"], "launches_deploy": deploy_launches,
        "max_abs_err": b1["max_abs_err_o"], "ms": b1["ms"], "plain_ms": b1["plain_ms"],
        "bound_ms": b1["bound_ms"], "bound_by": b1["bound_by"], "library_ms": b1["library_ms"],
        "site": "D_SA f32 " + "x".join(map(str, b1["shape"])),
        "launches_driver": driver_launches["B1"], "launches_fid_call": ev["b1_per_call"],
        "bf16": {"max_abs_err": b1h["max_abs_err_o"], "ms": b1h["ms"],
                 "plain_ms": b1h["plain_ms"], "bound_ms": b1h["bound_ms"],
                 "bound_by": b1h["bound_by"], "library_ms": b1h["library_ms"]},
    }, {
        "name": "attention_bwd (B2)", "route": "cuda",
        "source": "ieagan_torch/kernels/csrc/attention_bwd.cu",
        "replaces": "ieagan_tpu/ops/pallas/flash_attention.py:113",
        "launches": train_launches["B2"],
        "max_abs_err": max(b2["max_abs_err_dq"], b2["max_abs_err_dk"], b2["max_abs_err_dv"]),
        "ms": b2["ms"], "plain_ms": b2["plain_ms"], "bound_ms": b2["bound_ms"],
        "bound_by": b2["bound_by"], "library_ms": b2["library_ms"],
        "site": "D_SA f32 " + "x".join(map(str, b2["shape"])),
        "launches_driver": driver_launches["B2"],
        "bf16": {"max_abs_err": max(b2h["max_abs_err_dq"], b2h["max_abs_err_dk"],
                                    b2h["max_abs_err_dv"]),
                 "ms": b2h["ms"], "plain_ms": b2h["plain_ms"], "bound_ms": b2h["bound_ms"],
                 "bound_by": b2h["bound_by"], "library_ms": b2h["library_ms"]},
    }]
    print(f"total: {time.perf_counter() - t_all:.2f} s (train step {step_ms:.1f} ms f32, "
          f"peak {peak:.2f} GiB; driver step {driver_ms:.1f} ms bf16, peak "
          f"{driver_peak:.2f} GiB; FID of 2,000 images {ev['fid_s']:.2f} s, Inception "
          f"{ev['inception_ms']['f32']:.3f} ms per image; producer {ev['events_per_s']:.2f} "
          f"events/s)", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
