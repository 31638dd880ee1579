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
3b. the same for the fused attention backward (B2), against its plain version
   and SDPA's backward, at the three sites as the train step gives them;
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
   ``ieagan_torch/train/golden_step_copy16000.json``.

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
# once at the train step's batch of 40 images.
SITES = [
    ("RR_G", 2, 40, 40, 64, 64, 0.125),
    ("RR_D", 4, 40, 40, 128, 128, 128 ** -0.5),
    ("D_SA", 2, 3072, 768, 32, 128, 1.0),
    ("D_SA", 40, 3072, 768, 32, 128, 1.0),
]
BWD_SITES = [SITES[0], SITES[1], SITES[3]]
# |kernel - plain| <= ATOL + RTOL * |plain|. f32: scores of up to 128 products
# at |s| up to ~20 (scale 1 at D_SA) carry ~1e-6 relative rounding that exp
# amplifies; 1e-4 bounds it. bf16: o is rounded to bf16 on both sides from
# f32 sums that may straddle a rounding boundary: one bf16 ulp (2**-8
# relative); lse stays f32.
TOLERANCES = {"float32": {"o": (1e-4, 1e-4), "lse": (1e-4, 1e-4)},
              "bfloat16": {"o": (2e-2, 1e-2), "lse": (1e-4, 1e-4)}}
# B2 against its plain version, on dq, dk, dv: the same reasoning as o (both
# recompute p in f32 from the same lse; sums of up to 3072 products run in
# another order; bf16 rounds each gradient once at the end).
BWD_TOLERANCES = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 1e-2)}
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # H100 SXM: fp32 non-tensor, bf16 dense
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


def bwd_bound(b, lq, lkv, dk, dv, itemsize, dtype_name):
    """Least time for B2: q, k, v, o, dO and lse read once, dq, dk, dv written
    once, against the five products at the type's peak rate."""
    nbytes = (2 * (b * lq * dk + b * lkv * dk + b * lkv * dv) + 2 * b * lq * dv) * itemsize \
        + b * lq * 4
    flops = 2.0 * b * lq * lkv * (3 * dk + 2 * dv)
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
            want = attention_bwd_plain(q, k, v, o, lse, do, scale)
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
                "ms": time_ms(torch, lambda: attention_bwd(q, k, v, o, lse, do, scale)),
                "plain_ms": time_ms(torch, lambda: attention_bwd_plain(q, k, v, o, lse, do,
                                                                       scale)),
                "library_ms": time_ms(torch, lambda: torch.autograd.grad(
                    o4, (q4, k4, v4), do4, retain_graph=True)),
            }
            row["bound_ms"], row["bound_by"] = bwd_bound(b, lq, lkv, dk, dv, q.element_size(),
                                                         dname)
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


def main():
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, ROOT)
    from ieagan_torch.kernels import build
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
    bwd_rows = backward_vs_plain(torch, attention_fwd, attention_bwd, attention_bwd_plain)
    phase("backward kernel vs plain", t0)

    t0 = time.perf_counter()
    deploy_launches = main_path(torch, np)
    phase("deployment path", t0)

    t0 = time.perf_counter()
    train_launches, step_ms, peak = train_path(torch, np)
    phase("training path", t0)

    t0 = time.perf_counter()
    golden_step_phase(torch, np)
    phase("golden step", t0)

    # The heaviest site on the training path: D's image attention at 40 images.
    pick = lambda rs: next(r for r in rs if r["site"] == "D_SA" and r["shape"][0] == 40
                           and r["dtype"] == "float32")
    b1, b2 = pick(rows), pick(bwd_rows)
    kernels = [{
        "name": "attention_fwd (B1)", "route": "cuda",
        "source": "ieagan_torch/kernels/csrc/attention_fwd.cu",
        "replaces": "ieagan_tpu/ops/pallas/flash_attention.py:63",
        "launches": train_launches["B1"], "launches_deploy": deploy_launches,
        "max_abs_err": b1["max_abs_err_o"], "ms": b1["ms"], "plain_ms": b1["plain_ms"],
        "bound_ms": b1["bound_ms"], "bound_by": b1["bound_by"], "library_ms": b1["library_ms"],
        "site": "D_SA f32 " + "x".join(map(str, b1["shape"])),
    }, {
        "name": "attention_bwd (B2)", "route": "cuda",
        "source": "ieagan_torch/kernels/csrc/attention_bwd.cu",
        "replaces": "ieagan_tpu/ops/pallas/flash_attention.py:113",
        "launches": train_launches["B2"],
        "max_abs_err": max(b2["max_abs_err_dq"], b2["max_abs_err_dk"], b2["max_abs_err_dv"]),
        "ms": b2["ms"], "plain_ms": b2["plain_ms"], "bound_ms": b2["bound_ms"],
        "bound_by": b2["bound_by"], "library_ms": b2["library_ms"],
        "site": "D_SA f32 " + "x".join(map(str, b2["shape"])),
    }]
    print(f"total: {time.perf_counter() - t_all:.2f} s (train step {step_ms:.1f} ms, "
          f"peak {peak:.2f} GiB)", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
