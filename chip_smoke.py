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
   PyTorch version at the attention sites of the model (D's proxy RRM at
   head width 256 and the concat mode's sequences of 80 among them), f32 and
   bf16,
   with times of the kernel, the plain version, ``scaled_dot_product_attention``
   (a yardstick only; the port never calls it) and the card's bound; at a
   site that B1 runs in an instance of its own (G SA over 512 channels, the
   (64, 256) instance), also the time of the (256, 256) route it replaced;
3b. the same for the fused attention backward (B2), against its plain version
   and SDPA's backward, at the sites as the train step gives them;
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
   state and draws, and the time per step; then D and its Adam state after
   the steps through the reference PyTorch layout (a ``.pth``) and back,
   bit for bit;
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
10. the options the flagship leaves off, at the flagship's widths from a
   random init (every SA gamma 0.5): (a) PEGAN: ``generate_batched`` 1 and
   4 events per call with B1 at G's attention, fused against plain, the
   reference ``.pth`` round trip (``export_torch`` -> ``from_torch``, bit
   for bit), ms per event; (b) IEA-GAN as the reference trains it (concat D
   pass, full-batch RRM sequences, D's proxy RRM at head width 256,
   nonlinear and prior embeddings, consistency regularization); (c) Proj
   with CBAM, then ILA, in D and G's plain layers with group norm. (a) and
   (b) train two f32 steps fused and plain from one state and draws
   (phase 5's bounds) with B1/B2 launches by site and phase, then two bf16
   steps; (c) trains with no fused attention, weights moving.
11. data-parallel training: (a) ``torchrun --nproc-per-node 1
   train_torch.py --mesh 1`` on NCCL in bf16 at the flagship width, three
   steps and the final save, then a resume to step four (run beside (b)'s
   single-process steps and its ranks' set-up, its time not read); ms per
   step beside phase 7's;
   (b) two ranks spawned on the one card over gloo (NCCL refuses two ranks
   on one device), f32 with TF32 off, from ``copy16000``, one event of 40
   each with fixed draws, against one process taking both events: metrics
   and per-leaf gradients (phase 5's bounds, but G's median held to 1e-2; a
   yardstick printed beside it, one process with its batch-norm sums taken
   event by event), every rank's state bit-equal, a control on rank 0's
   event alone that must break the bounds; per rank B1/B2 launches, gloo
   calls, ms and MB, peak memory; (c) on the same two ranks, phase 10b's
   reference-parity configuration from its random init, the full-batch RRM
   sequences now spanning both ranks (160 and 80), against one process
   taking both events (11b's bounds), the ranks' states bit-equal, launches
   by site.
12. activation recompute: (a) the golden step of phase 6 with
   ``remat=True``; phase 5's first step with ``remat=True`` against phase
   5's own (G's buffers bit-equal, gradients within the fused-vs-plain
   bounds); a pair of steps without and with recompute under cuDNN's
   deterministic algorithms, every state tensor bit-equal; (b) the driver's
   bf16 step at the flagship widths from a random init, three steps each at
   3 events without recompute, with ``True``, ``"wide"`` and
   ``remat_D=True``, and at 1 event with ``True``: peak memory, ms per step,
   B1/B2 launches per step (those of phase 5: D's attention is in no
   segment, and the flagship's G has none).
13. the user tools, each through ``main(argv)`` as ``python -m
   ieagan_torch...`` runs it: (a) ``deploy.create_gan_digits`` from best0
   (``--tag best0``), 8 events at 4 a call into npz shards: the sha256
   line, the shard, B1's launches at RR_G, events per second; (b)
   ``eval.mint_stats --host-resize`` on phase 9's PNG tree with the
   fallback weights, equal to ``make_custom_stats``; (c) ``eval.moments_check``
   and (d) ``eval.kid_eval`` on a run dir holding best0, 400 images against
   (b)'s stats: ``kid_eval``'s FID equal to ``moments_check``'s host FID,
   seconds by part; (e) ``eval.finetune_inception`` on the PNG tree, its
   first step against the CPU's, the written backbone read back into
   ``FeatureExtractor`` bit-equal, ms per step and peak memory.
14. tensor parallelism: two gloo ranks on the one card on a 1x2 mesh (each
   holding half of every leaf the JAX rule splits, Adam moments and G_ema
   included), f32 with TF32 off, one step from ``copy16000`` on 11b's rank 0
   event and draws, against 11b's one-process step on that event (phase 11's
   bounds on gradients and Adam moments, parameters within twice the
   learning rate): the replicated leaves bit-equal on both ranks, each
   rank's split bytes half the whole, B1/B2 launches per rank by shape at
   the rank's share of the heads or channels (phases 3/3b hold those shapes
   against the plain versions), step ms and peak memory per rank.
15. BigGAN-deep 256 at its published widths (``BIGGAN_DEEP_256``) from a
   random init with SA's gain at 0.5: ``sample_batched`` of
   ``BIGGAN_DEEP_IMAGES`` images a call, its shape, range and B1 launches a
   call (one: the (64, 256) instance at G SA, which phase 3 holds against
   its plain version), against the plain reference
   ``references/biggan_deep.py`` from the same state, z and labels, with
   the reference in bfloat16 as a control that must break the bound; ms a
   call.

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
# once at the train step's batch of 40 images (PEGAN's G attention at 32x96,
# phase 10a, has the same shape). RR_Dproxy is D's proxy RRM (RRM_prx_D: 4
# heads of 256, the kernels' 256 instance) at one event and, as concat mode
# with the full-batch sequence gives it (phase 10b), at one sequence of 80,
# where RR_D runs at 80 too, and at one sequence of 160, as two ranks of one
# event each give them (phase 11c: the ranks' global batch of [fake; real]
# pairs). ODD, WIDE and ODD256 are no site of the model:
# widths that are padded inside the kernels ((5, 7) -> (32, 32), (100, 48) ->
# (128, 64), (200, 130) -> (256, 256), whose second column tile holds two of
# dv's columns), ragged lengths, and rows that are not 16-byte aligned (ODD
# and ODD256 in both types, WIDE in bf16), so the element-wise load path runs.
SITES = [
    ("RR_G", 2, 40, 40, 64, 64, 0.125),
    ("RR_D", 4, 40, 40, 128, 128, 128 ** -0.5),
    ("D_SA", 2, 3072, 768, 32, 128, 1.0),
    ("D_SA", 40, 3072, 768, 32, 128, 1.0),
    ("ODD", 3, 77, 45, 5, 7, 0.5),
    ("WIDE", 3, 130, 200, 100, 48, 0.2),
    ("RR_Dproxy", 4, 40, 40, 256, 256, 256 ** -0.5),
    ("RR_Dproxy", 4, 80, 80, 256, 256, 256 ** -0.5),
    ("RR_D", 4, 80, 80, 128, 128, 128 ** -0.5),
    ("ODD256", 3, 77, 45, 200, 130, 0.3),
    ("RR_D", 4, 160, 160, 128, 128, 128 ** -0.5),
    ("RR_Dproxy", 4, 160, 160, 256, 256, 256 ** -0.5),
    # each rank's sites under tensor parallelism at model 2 (phase 14): RR_G
    # one head of its two, RR_D two of four, D SA the half of v's channels
    # that the split g gives it (the (32, 64) instance)
    ("RR_G", 1, 40, 40, 64, 64, 0.125),
    ("RR_D", 2, 40, 40, 128, 128, 128 ** -0.5),
    ("D_SA", 40, 3072, 768, 32, 64, 1.0),
    # BigGAN-deep 256's G self-attention at 64x64 over 512 channels, at the
    # benchmark's 128 images a call: B1's own (64, 256) instance
    ("G_SA", 128, 4096, 1024, 64, 256, 1.0),
]
BWD_SITES = [SITES[i] for i in (0, 1, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14)]
TP_SITES = SITES[12:15]
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
# Phase 10: the options the flagship leaves off, at the flagship's widths from
# a random init (the repo has weights for none of them): PEGAN (the paper's
# comparison model with G attention at 32, scripts/eval_all.py), IEA-GAN as
# the reference trains it (concat D pass with the whole batch as one RRM
# sequence, D's proxy RRM, nonlinear embedding, prior embedding with a seeded
# table, consistency regularization), and a BigGAN-style Proj model with
# CBAM (then ILA) in D and G's plain layers, group norm and no hierarchy.
OPTION_CONFIGS = {
    "10a PEGAN": dict(G_attn="32", RRM_prx_G=False, rdof_dim=0),
    "10b reference parity": dict(split_D=False, rrm_full_batch_sequence=True, RRM_prx_D=True,
                                 nonlinear_embed=True, prior_embed=True, Con_reg=True),
    "10c Proj": dict(conditional_strategy="Proj", attn_type="cbam", D_attn="32", Con_reg=True,
                     RRM_prx_G=False, rdof_dim=0, hier=False, norm_style="grp_16",
                     G_param="plain"),
}
# Launches per train step by kernel and site (phase 10, one event of 40):
# B1 at every attention of every forward; B2 wherever the loss needs the
# site's gradient. 10a: G SA in both G passes, D SA and RR_D in D's three
# passes; B2 at G SA in the G phase, D SA in all three D passes, RR_D in the
# D phase's real pass and the G phase. 10b: one D pass over [fake; real]
# (RRMs at one sequence of 80), the consistency pass over the reals and the
# G phase's pass (RRMs at 40); RR_Dproxy's gradient is needed only where a
# loss reads the proxy with D's parameters live: the concat pass's contrastive
# loss (the consistency loss reads no proxy, and in the G phase the proxy
# depends on no parameter of G). 10c runs no fused attention: no RRM, CBAM
# and ILA have no kernel.
OPTION_LAUNCHES = {
    "10a PEGAN": {("B1", "SA"): 5, ("B1", "RR_D L40"): 3,
                  ("B2", "SA"): 4, ("B2", "RR_D L40"): 2},
    "10b reference parity": {
        ("B1", "RR_G L40"): 2, ("B1", "SA"): 3, ("B1", "RR_D L80"): 1, ("B1", "RR_D L40"): 2,
        ("B1", "RR_Dproxy L80"): 1, ("B1", "RR_Dproxy L40"): 2,
        ("B2", "RR_G L40"): 1, ("B2", "SA"): 3, ("B2", "RR_D L80"): 1, ("B2", "RR_D L40"): 2,
        ("B2", "RR_Dproxy L80"): 1},
    "10c Proj": {},
}
OPTION_PRIOR_SEED = 40
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


# Phase 12: activation recompute. 12a holds phase 5's f32 step from copy16000
# with remat=True to the golden file (phase 6's bounds: the JAX package made
# it with remat on) and to phase 5's own step without recompute (the state
# leaves the forwards write bit-equal, gradients within the fused-vs-plain
# bounds), and a pair of steps without and with recompute under cuDNN's
# deterministic algorithms to each other, every state leaf bit-equal. 12b
# runs the driver's bf16 step, random init at the flagship widths, three
# steps of each configuration: at 3 events without recompute, with True,
# "wide", and remat_D=True alone (the JAX package's recipe at 3 events), and
# at 1 event with True (phase 7's step is the one without); peak memory
# (reset before each), ms per step (steps 2-3), B1/B2 launches per step.
REMAT_RUNS = [("off", 3, {}), ("True", 3, {"remat": True}), ("wide", 3, {"remat": "wide"}),
              ("remat_D=True", 3, {"remat_D": True}), ("True", 1, {"remat": True})]
REMAT_STEPS = 3


def remat_step(torch, config, first, deterministic=False):
    """One f32 step from copy16000 on phase 5's first inputs and draws under
    ``config``: the metrics, gradients and state (host copies)."""
    from ieagan_torch.train.step import make_train_step, restore_train_state

    flag = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    try:
        state = restore_train_state(CHECKPOINT, "copy16000", device="cuda", config=config)
        m = make_train_step(state.G, state.D, config, draw_schedule=first["schedule"],
                            capture_grads=True)(state, first["x"], first["y"])
    finally:
        torch.backends.cudnn.deterministic = flag
    host = lambda d: {k: v.detach().cpu() for k, v in d.items()}
    out = {"metrics": {k: v for k, v in m.items() if not k.startswith("_")},
           "grads": {**{f"G.{k}": v for k, v in host(m["_grads_G"]).items()},
                     **{f"D.{k}": v for k, v in host(m["_grads_D"]).items()}},
           "G": host(state.G.state_dict()), "D": host(state.D.state_dict()),
           "G_ema": host(state.G_ema.state_dict())}
    del state, m
    torch.cuda.empty_cache()
    return out


def remat_golden(torch, np, first):
    """12a: with remat=True, the golden step, then phase 5's step against
    phase 5's own without recompute, then a deterministic pair."""
    golden = golden_step_phase(torch, np, {"remat": True},
                               "12a golden step copy16000, remat=True")
    got = remat_step(torch, {"remat": True}, first)
    errs = leaf_errors(np, got["grads"], first["grads"])
    med = float(np.median(list(errs.values())))
    keys = list(first["metrics"])
    m_rel = max(abs(got["metrics"][k] - first["metrics"][k]) / max(abs(first["metrics"][k]), 1e-12)
                for k in keys)
    m_ok = all(abs(got["metrics"][k] - first["metrics"][k])
               <= STEP_METRIC_ATOL + STEP_METRIC_RTOL * abs(first["metrics"][k]) for k in keys)
    buffers = {net: [k for k in first[net] if f"{net}.{k}" not in got["grads"]]
               for net in ("G", "D")}
    unequal = {net: [k for k in names if not torch.equal(got[net][k], first[net][k])]
               for net, names in buffers.items()}
    worst = {net: max((float((got[net][k] - first[net][k]).abs().max()) for k in names),
                      default=0.0) for net, names in unequal.items()}
    print(f"12a remat=True vs phase 5's step without: metrics max rel diff {m_rel:.3e}; gradient "
          f"per-leaf error max {max(errs.values()):.3e}, median {med:.3e} (bounds {STEP_GRAD_MAX}, "
          f"{STEP_GRAD_MEDIAN}); state buffers (u, sv, BN stats) not bit-equal: G "
          f"{len(unequal['G'])} of {len(buffers['G'])}, D {len(unequal['D'])} of "
          f"{len(buffers['D'])} (max abs {worst['G']:.3e} / {worst['D']:.3e})", flush=True)
    if not (m_ok and max(errs.values()) < STEP_GRAD_MAX and med < STEP_GRAD_MEDIAN):
        raise SystemExit("12a: the step with recompute disagrees with phase 5's step")
    if unequal["G"]:
        raise SystemExit(f"12a: G's buffers differ with recompute: {unequal['G'][:5]}")
    del got
    pair = [remat_step(torch, cfg, first, deterministic=True) for cfg in ({}, {"remat": True})]
    differ = [f"{net}.{k}" for net in ("G", "D", "G_ema") for k, v in pair[0][net].items()
              if not torch.equal(v, pair[1][net][k])]
    grads_equal = sum(torch.equal(v, pair[1]["grads"][k]) for k, v in pair[0]["grads"].items())
    print(f"12a deterministic cuDNN, without vs with recompute: {len(differ)} of "
          f"{sum(len(p) for p in (pair[0]['G'], pair[0]['D'], pair[0]['G_ema']))} state tensors "
          f"differ {differ[:5]}; gradients bit-equal {grads_equal} of {len(pair[0]['grads'])}; "
          f"metrics equal {pair[0]['metrics'] == pair[1]['metrics']}", flush=True)
    if differ:
        raise SystemExit("12a: recompute changed the state under deterministic algorithms")
    return golden, max(errs.values()), med


def remat_memory(torch, np, driver_ms, driver_peak):
    """12b: the driver's bf16 step with and without recompute."""
    import gc
    import ieagan_torch.kernels.flash_attention as fa
    from ieagan_torch.core.config import DEFAULT_CONFIG
    from ieagan_torch.models.discriminator import Discriminator
    from ieagan_torch.models.generator import Generator
    from ieagan_torch.parallel.sharding import make_sharded_train_step
    from ieagan_torch.train.step import init_train_state

    out = []
    for label, epb, keys in REMAT_RUNS:
        cfg = dict(DEFAULT_CONFIG, events_per_batch=epb, **keys)
        gen = torch.Generator(device="cuda").manual_seed(16)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with torch.device("cuda"):
            G, D = Generator.from_config(cfg), Discriminator.from_config(cfg)
        state = init_train_state(G, D, cfg, gen, torch.bfloat16)
        step = make_sharded_train_step(G, D, cfg, None)
        x = torch.rand((40 * epb, 256, 768, 1), generator=gen, device="cuda") * 2 - 1
        y = torch.cat([torch.randperm(40, generator=gen, device="cuda") for _ in range(epb)])
        ms, launches = [], []
        for _ in range(REMAT_STEPS):
            fa.attention_fwd.launches = fa.attention_bwd.launches = 0
            torch.cuda.synchronize()
            t = time.perf_counter()
            m = step(state, x, y, gen)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            launches.append((fa.attention_fwd.launches, fa.attention_bwd.launches))
            if not all(np.isfinite(v) for v in m.values()):
                raise SystemExit(f"12b {label} at {epb} events: non-finite metric {m}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        row = {"remat": label, "events": epb, "modes": [G.remat, D.remat], "peak_gib": peak,
               "ms": ms[1:], "step1_ms": ms[0], "launches_per_step": launches[-1]}
        print("12b bf16 driver step " + json.dumps(row), flush=True)
        if set(launches) != {(B1_PER_STEP, B2_PER_STEP)}:
            raise SystemExit(f"12b {label} at {epb} events: B1/B2 launched {launches}, expected "
                             f"{(B1_PER_STEP, B2_PER_STEP)} per step")
        out.append(row)
        del state, step, G, D, x, y, m
    gc.collect()
    torch.cuda.empty_cache()
    peak = {(r["remat"], r["events"]): r["peak_gib"] for r in out}
    print(f"12b peak GiB at 3 events: off {peak[('off', 3)]:.2f}, True {peak[('True', 3)]:.2f}, "
          f"wide {peak[('wide', 3)]:.2f}, remat_D=True {peak[('remat_D=True', 3)]:.2f}; at 1 "
          f"event: True {peak[('True', 1)]:.2f} (phase 7 without: {driver_peak:.2f} GiB, "
          f"{driver_ms:.1f} ms)", flush=True)
    if not peak[("True", 3)] < peak[("off", 3)]:
        raise SystemExit("12b: remat=True at 3 events does not peak below no recompute")
    return out


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
    """Phase 3: B1 against its plain version at each site and type. Where
    B1's instance is not B2's (``fwd_pair``), ``route_256_ms`` times the
    (256, 256) instance on the same inputs, q and k zero-padded to 136
    columns (past 128, 16-byte rows in both types): the route the site took
    before, reading 72 more columns of q and k from memory."""
    from ieagan_torch.kernels.flash_attention import fwd_pair, padded_pair
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
            if fwd_pair(dk, dv) != padded_pair(dk, dv):
                qw, kw = (F.pad(t, (0, 136 - dk)) for t in (q, k))
                o_w, _ = attention_fwd(qw, kw, v, scale)
                row["route_256_max_abs_diff_o"] = float((o_w.float() - o.float()).abs().max())
                row["route_256_ms"] = time_ms(torch, lambda: attention_fwd(qw, kw, v, scale))
                del qw, kw, o_w
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
    reference_round_trip(torch, state)
    fused_grads, fused_mets = grads, mets[0]
    host = lambda d: {k: v.detach().cpu() for k, v in d.items()}
    first = {"x": x, "y": y, "schedule": schedule, "grads": host(grads),
             "metrics": {k: v for k, v in fused_mets.items() if not k.startswith("_")},
             "G": host(G1), "D": host(D1)}
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
    return launches, sum(steady) / len(steady), peak, first


def reference_round_trip(torch, state):
    """Phase 5's D and its Adam state (after the steps) through the
    reference PyTorch layout, as a ``.pth`` file holds them, and back into
    a fresh D and optimizer: every tensor, moment and count bit-equal."""
    import io
    from ieagan_torch.core.config import DEFAULT_CONFIG
    from ieagan_torch.models.convert import (discriminator_state_from_torch,
                                             discriminator_state_to_torch,
                                             optimizer_state_from_torch,
                                             optimizer_state_to_torch)
    from ieagan_torch.models.discriminator import Discriminator
    from ieagan_torch.train.optim import make_optimizer

    def through_file(obj):
        buf = io.BytesIO()
        torch.save(obj, buf)
        buf.seek(0)
        return torch.load(buf, weights_only=True)

    t = time.perf_counter()
    D, opt = state.D, state.opt_D
    sd = through_file(discriminator_state_to_torch(D))
    osd = through_file(optimizer_state_to_torch(opt, D, lr=DEFAULT_CONFIG["D_lr"]))
    with torch.device("cuda"):
        other = Discriminator.from_config(DEFAULT_CONFIG)
    back = discriminator_state_from_torch(sd, DEFAULT_CONFIG["D_depth"], other.state_dict())
    other.load_state_dict({k: torch.from_numpy(v) for k, v in back.items()}, strict=True)
    want = D.state_dict()
    differ = [k for k, v in other.state_dict().items() if not torch.equal(v, want[k])]
    fresh = make_optimizer(other.parameters(), DEFAULT_CONFIG["D_B1"], DEFAULT_CONFIG["D_B2"],
                           DEFAULT_CONFIG["adam_eps"])
    optimizer_state_from_torch(fresh, other, osd)
    ours = dict(zip((n for n, _ in D.named_parameters()), opt.params))
    theirs = dict(zip((n for n, _ in other.named_parameters()), fresh.params))
    differ += [f"{n}.{m}" for n in ours for m in ("mu", "nu")
               if not torch.equal(fresh.state[theirs[n]][m], opt.state[ours[n]][m])]
    print(f"phase 5 reference layout: D ({len(sd)} tensors) and its Adam state "
          f"({len(osd['state'])} parameters, step {float(osd['state'][0]['step']):.0f}) "
          f"through a .pth and back in "
          f"{time.perf_counter() - t:.2f} s; differing: {differ[:5]} ({len(differ)})", flush=True)
    if differ or fresh.count != opt.count or set(want) != set(other.state_dict()):
        raise SystemExit("phase 5: the reference-layout round trip changed D or its Adam state")
    del other, fresh


def golden_step_phase(torch, np, config=None, label="golden step copy16000"):
    """Phase 6 (and 12a with ``config`` {"remat": True}): the first step
    from copy16000 against the JAX package's."""
    from ieagan_torch.train import golden_step
    from ieagan_torch.train.step import make_train_step, restore_train_state

    config = config or {}
    g = golden_step.load()
    x, y, _ = golden_step.inputs(g["seed"])
    state = restore_train_state(CHECKPOINT, golden_step.CHECKPOINT_TAG, device="cuda",
                                config=config)
    m = make_train_step(state.G, state.D, config, draw_schedule=golden_step.draw_schedule(g),
                        capture_grads=True)(state, torch.tensor(x, device="cuda"),
                                            torch.tensor(y, device="cuda").long())
    grads = {net: {k: v.cpu().numpy() for k, v in m[f"_grads_{net}"].items()}
             for net in ("G", "D")}
    result = golden_step.compare(g, golden_step.summarize(m, grads, g["entries"]))
    del state, m
    torch.cuda.empty_cache()
    print(f"{label}: " + json.dumps(result) + f" (tolerances: metrics rtol "
          f"{golden_step.METRIC_RTOL} atol {golden_step.METRIC_ATOL}, module gradient norms "
          f"rel {golden_step.NORM_RTOL}, entries {golden_step.ENTRY_RMS_TOL} of their "
          f"leaf's RMS)", flush=True)
    if not (result["metrics_ok"] and result["module_norm_ok"] and result["entries_ok"]):
        raise SystemExit(f"{label}: the card's train step disagrees with "
                         "golden_step_copy16000.json")
    return result


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
    make_step, save_ckpt = driver.make_sharded_train_step, driver.save_checkpoint
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

    driver.make_sharded_train_step, driver.save_checkpoint = counted_make_train_step, timed_save
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
        driver.make_sharded_train_step, driver.save_checkpoint = make_step, save_ckpt
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


def site_of(shape):
    """The attention site of a fused call by its q shape (B, L, d)."""
    _, length, width = shape
    if length >= 1000:
        return "SA"
    return {64: "RR_G", 128: "RR_D", 256: "RR_Dproxy"}.get(width, str(tuple(shape))) + f" L{length}"


def option_state(torch, cfg, compute_dtype, seed=10):
    """A random-init TrainState for ``cfg`` on the card, every SA gamma at 0.5
    so that the attention counts (gamma starts at 0)."""
    from ieagan_torch.core.config import DEFAULT_CONFIG
    from ieagan_torch.models.discriminator import Discriminator
    from ieagan_torch.models.generator import Generator
    from ieagan_torch.ops.attention import SelfAttention2d
    from ieagan_torch.train.step import init_train_state

    full = dict(DEFAULT_CONFIG, **cfg)
    with torch.device("cuda"):
        G, D = Generator.from_config(full), Discriminator.from_config(full)
    state = init_train_state(G, D, full, torch.Generator(device="cuda").manual_seed(seed),
                             compute_dtype)
    with torch.no_grad():
        for m in [*G.modules(), *D.modules(), *state.G_ema.modules()]:
            if isinstance(m, SelfAttention2d):
                m.gamma.fill_(0.5)
    return state


def option_schedule(torch, gen, cfg, steps, es=40, device="cuda"):
    """The draws of ``steps`` f32 train steps under ``cfg`` for a batch of
    ``es`` images, in the step's order (``train/step.py``)."""
    from ieagan_torch.core.config import DEFAULT_CONFIG
    from ieagan_torch.ops.diff_aug import sample_cr_draws, sample_diff_aug_draws
    full = dict(DEFAULT_CONFIG, **cfg)
    randn = lambda n: torch.randn((es, n), generator=gen, device=device)
    latents = lambda: [randn(128)] + ([randn(full["rdof_dim"])] if full["RRM_prx_G"] else [])
    aug = lambda: sample_diff_aug_draws(gen, es, 256, 768, device=device)
    out = []
    for _ in range(steps):
        out += latents() + [aug(), aug()]
        out += [sample_cr_draws(gen, es, 256, 768, device=device)] if full["Con_reg"] else []
        out += latents() + [aug()]
    return out


class SiteCounter:
    """Observation only: wraps FlashAttention's forward and backward to count
    calls by kernel, site and phase (D phase while D takes gradients), or,
    given ``key``, by kernel and ``key(q, k, v)``."""

    def __init__(self, fa, key=None):
        self.fa, self.counts, self.D, self.key = fa, {}, None, key

    def __enter__(self):
        fa = self.fa
        self.fwd, self.bwd = fa.FlashAttention.forward, fa.FlashAttention.backward

        def seen(kernel, q, k, v):
            if self.key is not None:
                key = (kernel, self.key(q, k, v))
            else:
                phase = "D" if self.D is not None and self.D.linear0.weight.requires_grad else "G"
                key = (kernel, site_of(q.shape), phase)
            self.counts[key] = self.counts.get(key, 0) + 1

        fwd, bwd = self.fwd, self.bwd
        fa.FlashAttention.forward = staticmethod(
            lambda ctx, q, k, v, *a: seen("B1", q, k, v) or fwd(ctx, q, k, v, *a))
        fa.FlashAttention.backward = staticmethod(
            lambda ctx, do: seen("B2", *ctx.saved_tensors[:3]) or bwd(ctx, do))
        return self

    def __exit__(self, *exc):
        self.fa.FlashAttention.forward = self.fwd
        self.fa.FlashAttention.backward = self.bwd

    def take(self):
        counts, self.counts = self.counts, {}
        return counts


def attention_shape(q, k, v):
    """(B, Lq, Lkv, dk, dv) of an attention call."""
    return tuple(int(n) for n in (q.shape[0], q.shape[1], k.shape[1], q.shape[2], v.shape[2]))


def by_site(counts):
    """{(kernel, site): n} summed over phases."""
    out = {}
    for (kernel, site, _), n in counts.items():
        out[(kernel, site)] = out.get((kernel, site), 0) + n
    return out


class F64Attention:
    """Observation only: the plain attention composition taken in f64 (its
    inputs widened, its output rounded to their type), the yardstick both
    f32 attentions of phase 10's steps are read against."""

    def __init__(self, torch):
        import ieagan_torch.ops.attention as attention
        import ieagan_torch.ops.rrm as rrm
        self.modules, self.torch = (attention, rrm), torch

    def __enter__(self):
        torch = self.torch
        self.saved = [m.dot_softmax_attention for m in self.modules]

        def f64(q, k, v, scale=1.0, fused=False):
            del fused
            logits = torch.matmul(q.double(), k.double().transpose(-1, -2)) * scale
            return torch.matmul(torch.softmax(logits, dim=-1), v.double()).to(v.dtype)

        for m in self.modules:
            m.dot_softmax_attention = f64
        return self

    def __exit__(self, *exc):
        for m, fn in zip(self.modules, self.saved):
            m.dot_softmax_attention = fn


def option_train(torch, np, name, cfg, sites, steps=2):
    """Phase 10 training: ``steps`` f32 steps fused and plain from the same
    state and draws (phase 5's bounds on every step's metrics and on the
    first step's per-leaf gradients), the kernels' launches per step by site,
    then ``steps`` bf16 steps. The first step's gradients of both are also
    read against the same step with the attention in f64 (printed). Returns
    per-step launches and ms."""
    import ieagan_torch.kernels.flash_attention as fa
    from ieagan_torch.train.step import make_train_step

    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.rand((40, 256, 768, 1), generator=gen, device="cuda") * 2 - 1
    y = torch.randperm(40, generator=gen, device="cuda")
    schedule = option_schedule(torch, gen, cfg, steps)
    runs = {}
    for label, fused in (("fused", True), ("plain", False), ("f64", False)):
        run_cfg = dict(cfg, use_pallas_attention=fused)
        if label == "f64":
            with F64Attention(torch):
                state = option_state(torch, run_cfg, torch.float32)
                m = make_train_step(state.G, state.D, run_cfg, draw_schedule=schedule,
                                    capture_grads=True)(state, x, y)
            runs[label] = ([m],)
            del state, m
            torch.cuda.empty_cache()
            continue
        state = option_state(torch, run_cfg, torch.float32)
        before = {k: v.clone() for k, v in state.G.state_dict().items()}
        before_d = {k: v.clone() for k, v in state.D.state_dict().items()}
        step = make_train_step(state.G, state.D, run_cfg, draw_schedule=schedule,
                               capture_grads=True)
        sites.D = state.D
        mets, ms, launches = [], [], []
        for _ in range(steps):
            fa.attention_fwd.launches = fa.attention_bwd.launches = 0
            sites.take()
            torch.cuda.synchronize()
            t = time.perf_counter()
            m = step(state, x, y)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            launches.append({"B1": fa.attention_fwd.launches, "B2": fa.attention_bwd.launches,
                             "sites": sites.take()})
            mets.append(m)
        moved = {net: sum(not torch.equal(v, b[k]) for k, v in mod.state_dict().items()
                          if k in dict(mod.named_parameters()))
                 for net, mod, b in (("G", state.G, before), ("D", state.D, before_d))}
        runs[label] = (mets, ms, launches, moved)
        del state, step
        torch.cuda.empty_cache()
    mets, ms, launches, moved = runs["fused"]
    expect = OPTION_LAUNCHES[name]
    for i, (m, t, c) in enumerate(zip(mets, ms, launches)):
        got = by_site(c["sites"])
        print(f"{name} f32 step {i + 1}: {t:.1f} ms, B1 {c['B1']}, B2 {c['B2']} launches, by "
              f"site {json.dumps({f'{k} {s}': n for (k, s), n in sorted(got.items())})}; "
              + json.dumps({k: v for k, v in m.items() if not k.startswith('_')}), flush=True)
        if not all(np.isfinite(v) for k, v in m.items() if not k.startswith("_")):
            raise SystemExit(f"{name} step {i + 1}: non-finite metric")
        if got != expect or (c["B1"], c["B2"]) != (
                sum(n for (k, _), n in expect.items() if k == "B1"),
                sum(n for (k, _), n in expect.items() if k == "B2")):
            raise SystemExit(f"{name} step {i + 1}: launches {c['B1']}, {c['B2']} by site {got}, "
                             f"expected {expect}")
    print(f"{name}: parameter leaves moved in step 1 and 2: {moved}", flush=True)
    if not (moved["G"] and moved["D"]):
        raise SystemExit(f"{name}: the weights did not move")
    if expect:
        pm = runs["plain"][0]
        for i in range(steps):
            keys = [k for k in pm[i] if not k.startswith("_")]
            m_rel = max(abs(mets[i][k] - pm[i][k]) / max(abs(pm[i][k]), 1e-12) for k in keys)
            if not all(abs(mets[i][k] - pm[i][k]) <= STEP_METRIC_ATOL + STEP_METRIC_RTOL
                       * abs(pm[i][k]) for k in keys):
                raise SystemExit(f"{name} step {i + 1}: fused metrics disagree with plain "
                                 f"(max rel {m_rel:.3e})")
            print(f"{name} fused vs plain, step {i + 1}: metrics max rel diff {m_rel:.3e}",
                  flush=True)
        grads = lambda m: {**{f"G.{k}": v for k, v in m["_grads_G"].items()},
                           **{f"D.{k}": v for k, v in m["_grads_D"].items()}}
        errs = leaf_errors(np, grads(mets[0]), grads(pm[0]))
        med = float(np.median(list(errs.values())))
        worst = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
        print(f"{name} fused vs plain, step 1 gradients: per-leaf normalized error max "
              f"{max(errs.values()):.3e}, median {med:.3e} over {len(errs)} leaves "
              f"(tolerance max {STEP_GRAD_MAX}, median {STEP_GRAD_MEDIAN}); worst {worst}",
              flush=True)
        if not (max(errs.values()) < STEP_GRAD_MAX and med < STEP_GRAD_MEDIAN):
            raise SystemExit(f"{name}: the fused step's gradients disagree with the plain step's")
        for label in ("fused", "plain"):
            e = leaf_errors(np, grads(runs[label][0][0]), grads(runs["f64"][0][0]))
            worst = sorted(e.items(), key=lambda kv: -kv[1])[:2]
            print(f"{name} {label} vs f64 attention, step 1 gradients (yardstick): per-leaf max "
                  f"{max(e.values()):.3e}, median {float(np.median(list(e.values()))):.3e}; "
                  f"worst {worst}", flush=True)
    del runs
    torch.cuda.empty_cache()

    state = option_state(torch, cfg, torch.bfloat16)
    step = make_train_step(state.G, state.D, cfg)
    sites.D = state.D
    bf16_ms = []
    for i in range(steps):
        fa.attention_fwd.launches = fa.attention_bwd.launches = 0
        sites.take()
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = step(state, x, y, gen)
        torch.cuda.synchronize()
        bf16_ms.append((time.perf_counter() - t) * 1e3)
        got = by_site(sites.take())
        print(f"{name} bf16 step {i + 1}: {bf16_ms[-1]:.1f} ms, B1 {fa.attention_fwd.launches}, "
              f"B2 {fa.attention_bwd.launches} launches; "
              + json.dumps({k: v for k, v in m.items() if not k.startswith("_")}), flush=True)
        if got != expect or not all(np.isfinite(v) for v in m.values()):
            raise SystemExit(f"{name} bf16 step {i + 1}: launches {got} (expected {expect}) or "
                             "a non-finite metric")
    del state, step
    torch.cuda.empty_cache()
    return launches[-1], ms, bf16_ms


def pegan_deploy(torch, np, cfg):
    """Phase 10a's deployment: PEGAN from a random init through the user's
    entry points, fused against plain, and through the reference layout."""
    import tempfile
    import ieagan_torch.kernels.flash_attention as fa
    from ieagan_torch.deploy import Model, generate_batched

    def model(config, seed=12):
        m = Model(config=config, device="cuda", seed=seed)
        with torch.no_grad():
            for name in ("attn_2",):
                getattr(m.G, name).gamma.fill_(0.5)
        return m

    fused = model(cfg)
    plain = model(dict(cfg, use_pallas_attention=False))
    es, width = fused.event_size, 256 * fused.config["H_base"]
    if [n for n in fused.G.layer_names if n.startswith("attn")] != ["attn_2"]:
        raise SystemExit(f"PEGAN: G attention at {fused.G.layer_names}, expected attn_2")
    gen = torch.Generator(device="cuda").manual_seed(13)
    fa.attention_fwd.launches = 0
    one = generate_batched(fused, 1, gen)
    four = generate_batched(fused, 4, gen)
    torch.cuda.synchronize()
    launches = fa.attention_fwd.launches
    print(f"10a PEGAN deploy: generate_batched(1) and (4), {launches} B1 launches", flush=True)
    if launches != 2:
        raise SystemExit(f"PEGAN: B1 launched {launches} times for 2 generator calls")
    check_events(np, one, (es, 250, width), "10a PEGAN generate_batched(1)")
    check_events(np, four, (4 * es, 250, width), "10a PEGAN generate_batched(4)")
    z, rdof = fused.draw(1, gen)
    with torch.inference_mode():
        err = float((fused.G(z, fused.labels(1), rdof) - plain.G(z, plain.labels(1), rdof))
                    .abs().max())
    print(f"10a PEGAN fused vs plain attention, tanh output: max abs diff {err:.3e} "
          f"(tolerance {FUSED_VS_PLAIN_ATOL})", flush=True)
    if not err <= FUSED_VS_PLAIN_ATOL:
        raise SystemExit("PEGAN: the fused model disagrees with the plain-attention model")
    with tempfile.TemporaryDirectory() as root:
        back = Model.from_torch(fused.export_torch(os.path.join(root, "pegan.pth")),
                                config=cfg, device="cuda")
    want, got = fused.G.state_dict(), back.G.state_dict()
    if set(want) != set(got) or not all(torch.equal(got[k], v) for k, v in want.items()):
        raise SystemExit("PEGAN: export_torch -> from_torch changed the state dict")
    if not torch.equal(back.events(z, rdof), fused.events(z, rdof)):
        raise SystemExit("PEGAN: export_torch -> from_torch changed the event")
    print(f"10a PEGAN export_torch -> from_torch: {len(want)} tensors bit-equal, the same event",
          flush=True)
    per_event = {}
    for epc in (1, 4):
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            generate_batched(fused, epc, gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3 / epc)
        per_event[epc] = sorted(times)[len(times) // 2]
        print(f"10a PEGAN generate_batched({epc}): {per_event[epc]:.2f} ms per event (median of "
              "4, host clock after synchronize)", flush=True)
    del fused, plain, back
    torch.cuda.empty_cache()
    return launches, per_event


def options_phase(torch, np):
    """Phase 10: the options the flagship leaves off, at full width."""
    import ieagan_torch.kernels.flash_attention as fa
    from ieagan_torch.ops.prior import set_prior_features

    set_prior_features(np.random.default_rng(OPTION_PRIOR_SEED).uniform(0.5, 2.0, 40))
    out = {}
    with SiteCounter(fa) as sites:
        t0 = time.perf_counter()
        name = "10a PEGAN"
        out["deploy_launches"], out["pegan_ms_per_event"] = pegan_deploy(
            torch, np, OPTION_CONFIGS[name])
        out[name] = option_train(torch, np, name, OPTION_CONFIGS[name], sites)
        phase(name, t0)
        t0 = time.perf_counter()
        name = "10b reference parity"
        out[name] = option_train(torch, np, name, OPTION_CONFIGS[name], sites)
        phase(name, t0)
        t0 = time.perf_counter()
        name = "10c Proj"
        out[name] = option_proj(torch, np, OPTION_CONFIGS[name], sites)
        phase(name, t0)
    return out


def option_proj(torch, np, cfg, sites):
    """Phase 10c: two f32 steps of the Proj model with CBAM in D, then one
    with ILA: finite metrics, weights that moved, no fused attention."""
    import ieagan_torch.kernels.flash_attention as fa
    from ieagan_torch.train.step import make_train_step

    gen = torch.Generator(device="cuda").manual_seed(14)
    x = torch.rand((40, 256, 768, 1), generator=gen, device="cuda") * 2 - 1
    y = torch.randperm(40, generator=gen, device="cuda")
    ms = []
    for attn, steps in (("cbam", 2), ("ila", 1)):
        run_cfg = dict(cfg, attn_type=attn)
        state = option_state(torch, run_cfg, torch.float32)
        sites.D = state.D
        before = {k: v.clone() for k, v in state.G.state_dict().items()}
        before_d = {k: v.clone() for k, v in state.D.state_dict().items()}
        step = make_train_step(state.G, state.D, run_cfg)
        fa.attention_fwd.launches = fa.attention_bwd.launches = 0
        for i in range(steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            m = step(state, x, y, gen)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            print(f"10c Proj ({attn} in D) f32 step {i + 1}: {ms[-1]:.1f} ms; " + json.dumps(m),
                  flush=True)
            if set(m) != {"D_loss_real", "D_loss_fake", "G_loss"} or not all(
                    np.isfinite(v) for v in m.values()):
                raise SystemExit(f"10c Proj ({attn}): metrics {m}")
        moved = {net: sum(not torch.equal(v, b[k]) for k, v in mod.state_dict().items()
                          if k in dict(mod.named_parameters()))
                 for net, mod, b in (("G", state.G, before), ("D", state.D, before_d))}
        kernels = {"B1": fa.attention_fwd.launches, "B2": fa.attention_bwd.launches}
        print(f"10c Proj ({attn} in D): parameter leaves moved {moved}; fused attention kernels "
              f"that ran: {kernels} (none expected: no RRM, no SA)", flush=True)
        if not (moved["G"] and moved["D"]) or any(kernels.values()) or sites.take():
            raise SystemExit(f"10c Proj ({attn}): weights moved {moved}, kernels {kernels}")
        del state, step
        torch.cuda.empty_cache()
    return ms


# Phase 11: data-parallel training. 11a runs the entry point as a user
# launches it on one GPU: torchrun with one process, --mesh 1, NCCL, the
# bf16 policy at the flagship width, three steps and the final save, then a
# resume to step four. 11b holds the data-parallel step to one process: the
# card holds one GPU and NCCL refuses two ranks on one device, so two ranks
# share it over gloo (which stages CUDA tensors through the host: its step
# time is no scaling number), each taking one event of 40 in f32 with TF32
# off, from copy16000 and fixed draws, against one process taking both
# events in one step. Every rank's whole state must be bit-equal after the
# step, and one process taking rank 0's event alone (the control) must
# break the bounds. The bounds are phase 5's (metrics; per-leaf gradient max
# of G and D; D's median) except G's per-leaf median: on the card a batch of
# 40 does not round as rows of a batch of 80 do (11b prints how far G's eval
# output for one event moves between the two), and from copy16000 the step
# amplifies any such rounding change in G's gradient to a few 1e-3 (PERF.md
# §6). One process on both events whose batch-norm sums are taken as the
# ranks take them (each event's, then added), a change of summation order
# alone, moves G's median by 5.2e-3 on the H100 (the yardstick 11b prints,
# not a bound); two ranks read 2.2e-3 there and the one-event
# control 1.3. G's median bound sits between the two.
PHASE11_STEPS = 3
PHASE11_RANKS = 2
PHASE11_G_MEDIAN = 1e-2
# 11c: phase 10b's reference-parity configuration (concat D pass, full-batch
# RRM sequences, D's proxy RRM, prior and nonlinear embeddings, Con_reg) from
# phase 10's random init, over the same two gloo ranks after 11b, one event
# each, against one process taking both (11b's bounds). Each rank's
# sequence is the global batch: the concat pass's [f_0; r_0; f_1; r_1] of
# 160, the consistency and G phase's passes' 80; launches per rank by site
# (the phases as in OPTION_LAUNCHES for 10b, every RRM length doubled).
PHASE11C_LAUNCHES = {
    ("B1", "RR_G L40"): 2, ("B1", "SA"): 3, ("B1", "RR_D L160"): 1, ("B1", "RR_D L80"): 2,
    ("B1", "RR_Dproxy L160"): 1, ("B1", "RR_Dproxy L80"): 2,
    ("B2", "RR_G L40"): 1, ("B2", "SA"): 3, ("B2", "RR_D L160"): 1, ("B2", "RR_D L80"): 2,
    ("B2", "RR_Dproxy L160"): 1}


def phase11_argv(root, *extra):
    return [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
            "1", os.path.join(ROOT, "train_torch.py"), "--outputroot", root, "--run-name", "dp",
            "--mesh", "1", "--debug", "true", "--debug_batches", str(PHASE11_STEPS),
            "--num_epochs", "1", "--log_interval", "1", "--sv_log_interval", "1000000",
            "--save_every", "1000000", "--test_every", "1000000", "--samples_per_class_sheet",
            "0", *extra]


def parallel_entry_point(np, alongside):
    """Phase 11a: ``torchrun --nproc-per-node 1 train_torch.py --mesh 1`` on
    NCCL, three bf16 steps and a save, then a resume to step four, during
    which ``alongside()`` runs in this process (the resume's time is not
    read). Returns the ms per step (host clock between the steps' log lines,
    steps 2-3) and what ``alongside`` returned."""
    import re
    import tempfile

    def launch(root, *extra):
        # loopback only: the card's machine has no other interface to offer
        env = dict(os.environ, NCCL_SOCKET_IFNAME="lo", GLOO_SOCKET_IFNAME="lo")
        return subprocess.Popen(phase11_argv(root, *extra), stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env)

    def finish(proc):
        try:
            out, err = proc.communicate(timeout=400)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"11a torchrun rc {proc.returncode}: {out[-3000:]}\n{err[-3000:]}")
        return out

    with tempfile.TemporaryDirectory() as root:
        t = time.perf_counter()
        out = finish(launch(root))
        run_s = time.perf_counter() - t
        if "mesh {'data': 1, 'model': 1} over 1 processes (nccl)" not in out:
            raise SystemExit(f"11a: the run did not train on a mesh over NCCL: {out[-3000:]}")
        logged = re.findall(r"^itr (\d+) \(([0-9.]+)s, ([0-9.]+)s/itr\)", out, re.M)
        itrs = {int(i): float(t) for i, _, t in logged}
        loop_s = max(float(e) for _, e, _ in logged) if logged else float("nan")
        if sorted(itrs) != list(range(1, PHASE11_STEPS + 1)):
            raise SystemExit(f"11a: steps logged {sorted(itrs)}: {out[-3000:]}")
        weights = os.path.join(root, "dp", "weights")
        if not os.path.exists(os.path.join(weights, f"D_optim_copy{PHASE11_STEPS}.msgpack")):
            raise SystemExit(f"11a: no checkpoint copy{PHASE11_STEPS}")
        t = time.perf_counter()
        proc = launch(root, "--resume", "true", "--num_epochs", "2", "--stop_after",
                      str(PHASE11_STEPS + 1))
        try:
            beside = alongside()
        finally:
            out2 = finish(proc)
        resume_s = time.perf_counter() - t
        if (f"Resuming from checkpoint 'copy{PHASE11_STEPS}'" not in out2
                or not re.search(rf"^itr {PHASE11_STEPS + 1} ", out2, re.M)
                or not os.path.exists(os.path.join(weights,
                                                   f"G_ema_copy{PHASE11_STEPS + 1}.msgpack"))):
            raise SystemExit(f"11a: the resume did not reach step {PHASE11_STEPS + 1}: "
                             f"{out2[-3000:]}")
    ms = [itrs[i] * 1e3 for i in range(2, PHASE11_STEPS + 1)]
    print(f"11a torchrun --nproc-per-node 1 --mesh 1 (NCCL, bf16): {run_s:.1f} s for "
          f"{PHASE11_STEPS} steps and a save ({loop_s:.1f} s of it from the train loop's start "
          f"to step {PHASE11_STEPS}'s log line); the resume beside 11b's single process "
          f"{resume_s:.1f} s; ms per step (steps 2-{PHASE11_STEPS}, host clock between log "
          "lines): " + ", ".join(f"{m:.1f}" for m in ms), flush=True)
    return float(np.mean(ms)), beside


def phase11_inputs(torch):
    """The global batch of 11b on the host: two events of 40 (uniform
    reals, each event's labels a permutation) and the step's fixed draws at
    the global shape (z, rdof, the fakes' and the reals' DiffAugment draws,
    then the G phase's)."""
    from ieagan_torch.ops.diff_aug import sample_diff_aug_draws

    n = 40 * PHASE11_RANKS
    gen = torch.Generator().manual_seed(11)
    x = torch.rand((n, 256, 768, 1), generator=gen) * 2 - 1
    y = torch.cat([torch.randperm(40, generator=gen) for _ in range(PHASE11_RANKS)])
    aug = lambda: sample_diff_aug_draws(gen, n, 256, 768, device="cpu")
    draw = lambda k: torch.randn((n, k), generator=gen)
    return x, y, [draw(128), draw(4), aug(), aug(), draw(128), draw(4), aug()]


def phase11c_state(torch):
    """11c's initial state: phase 10b's random init (prior features as
    phase 10 sets them)."""
    import numpy as np
    from ieagan_torch.ops.prior import set_prior_features

    set_prior_features(np.random.default_rng(OPTION_PRIOR_SEED).uniform(0.5, 2.0, 40))
    return option_state(torch, OPTION_CONFIGS["10b reference parity"], torch.float32)


def phase11c_inputs(torch):
    """11c's global batch on the host: two events of 40 and the step's draws
    at the global shape (``option_schedule``'s order)."""
    n = 40 * PHASE11_RANKS
    gen = torch.Generator().manual_seed(13)
    x = torch.rand((n, 256, 768, 1), generator=gen) * 2 - 1
    y = torch.cat([torch.randperm(40, generator=gen) for _ in range(PHASE11_RANKS)])
    return x, y, option_schedule(torch, gen, OPTION_CONFIGS["10b reference parity"], 1, es=n,
                                 device="cpu")


def phase11c_single(torch, x, y, schedule):
    """One process's f32 step of 11c on both events: metrics and gradients."""
    from ieagan_torch.train.step import make_train_step

    cfg = OPTION_CONFIGS["10b reference parity"]
    state = phase11c_state(torch)
    m = make_train_step(state.G, state.D, cfg, draw_schedule=[to_cuda(i) for i in schedule],
                        capture_grads=True)(state, x.cuda(), y.cuda())
    out = {"metrics": {k: v for k, v in m.items() if not k.startswith("_")},
           "grads": {f"{net}.{k}": v.cpu() for net in ("G", "D")
                     for k, v in m[f"_grads_{net}"].items()}}
    del state, m
    torch.cuda.empty_cache()
    return out


def to_cuda(item):
    """A scheduled draw (tensor or dict of tensors) on the card."""
    return {k: v.cuda() for k, v in item.items()} if isinstance(item, dict) else item.cuda()


def state_digest(state):
    """A sha256 per tensor of a train state (G, D, G_ema, Adam moments) and
    its counts."""
    import hashlib
    out = {}
    for net in ("G", "D", "G_ema"):
        for k, v in getattr(state, net).state_dict().items():
            out[f"{net}.{k}"] = hashlib.sha256(v.detach().cpu().numpy().tobytes()).hexdigest()
    for net in ("G", "D"):
        opt = getattr(state, f"opt_{net}")
        for k, p in getattr(state, net).named_parameters():
            for mom in opt.moment_names:
                out[f"opt_{net}.{k}.{mom}"] = hashlib.sha256(
                    opt.state[p][mom].cpu().numpy().tobytes()).hexdigest()
        out[f"opt_{net}.counts"] = (opt.count, opt.sched_count, state.itr)
    return out


def phase11_single(torch, x, y, schedule, split_moments=False, keep_state=False):
    """One process's f32 step from copy16000 on the given batch and draws:
    metrics and gradients, on the host. ``split_moments``: batch norm sums
    each event's rows and adds them, as the ranks' all-reduce does. With
    more than one event, also how far G's eval output for the first event
    moves between a batch of that event alone and the whole batch
    (``batch_rounding``, max abs over tanh; the step's new weights).
    ``keep_state``: also the parameters and Adam moments after the step
    (``tp_state``, host copies, by ``G.<name>`` and ``D.<name>``)."""
    import ieagan_torch.ops.norm as norm
    from ieagan_torch.train.step import make_train_step, restore_train_state

    def moments_by_event(xf):
        n = xf.numel() // xf.shape[1]
        sums = sum(torch.stack([e.sum(dim=(0, 2, 3)), (e * e).sum(dim=(0, 2, 3))])
                   for e in xf.split(40))
        mean = sums[0] / n
        return mean, sums[1] / n - mean * mean, n

    state = restore_train_state(CHECKPOINT, "copy16000", device="cuda")
    moments = norm._moments
    if split_moments:
        norm._moments = moments_by_event
    try:
        m = make_train_step(state.G, state.D, {}, draw_schedule=[to_cuda(i) for i in schedule],
                            capture_grads=True)(state, x.cuda(), y.cuda())
    finally:
        norm._moments = moments
    out = {"metrics": {k: v for k, v in m.items() if not k.startswith("_")},
           "grads": {f"{net}.{k}": v.cpu() for net in ("G", "D")
                     for k, v in m[f"_grads_{net}"].items()}}
    if keep_state:
        out["tp_state"] = params_and_moments(state)
    if x.shape[0] > 40:
        z, rdof, yc = schedule[0].cuda(), schedule[1].cuda(), y.cuda()
        with torch.no_grad():
            state.G.eval()
            alone = state.G(z[:40], yc[:40], rdof[:40])
            within = state.G(z, yc, rdof)[:40]
        out["batch_rounding"] = float((alone - within).abs().max())
    del state, m
    torch.cuda.empty_cache()
    return out


def event0_schedule(schedule):
    """Rank 0's event's rows of phase 11b's draws."""
    rows = slice(0, 40)
    return [{k: v[rows] for k, v in i.items()} if isinstance(i, dict) else i[rows]
            for i in schedule]


def params_and_moments(state):
    """Host copies of G's and D's parameters and Adam moments (by
    ``G.<name>``; moments under ``mu``/``nu``)."""
    out = {"params": {}, "mu": {}, "nu": {}}
    for net in ("G", "D"):
        opt = getattr(state, f"opt_{net}")
        for k, p in getattr(state, net).named_parameters():
            out["params"][f"{net}.{k}"] = p.detach().cpu()
            for m in ("mu", "nu"):
                out[m][f"{net}.{k}"] = opt.state[p][m].cpu()
    return out


def phase11_rank(rank, world, init_file, job_path, out_dir, go):
    """One rank of 11b and 11c, spawned: gloo on the card, one event. 11b:
    the sharded f32 step from copy16000, taken once ``go`` is set (the
    set-up runs beside 11a's resume); its launches, collective times, peak
    memory, the state's digest and (rank 0) metrics and gradients. Then
    11c: the reference-parity step from phase 10b's init, its launches by
    site, digest, metrics and gradients. Saved as ``rank<r>.pt``."""
    import torch
    import torch.distributed as dist

    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    sys.path.insert(0, ROOT)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        import ieagan_torch.kernels.flash_attention as fa
        from ieagan_torch.core.mesh import make_mesh
        from ieagan_torch.parallel.sharding import (host_local_batch, make_sharded_train_step,
                                                    place_state)
        from ieagan_torch.train.step import restore_train_state

        job = torch.load(job_path, weights_only=False)
        mesh = make_mesh(world)
        state = place_state(restore_train_state(CHECKPOINT, "copy16000", device="cuda"), mesh)
        x, y = host_local_batch(mesh, job["x"].cuda(), job["y"].cuda())
        step = make_sharded_train_step(state.G, state.D, {}, mesh,
                                       draw_schedule=[to_cuda(i) for i in job["schedule"]],
                                       capture_grads=True)
        if not go.wait(900):
            raise SystemExit(f"11b rank {rank}: no signal to step")
        # observation only: each collective timed between synchronizations
        coll = {}

        def timed(name, fn):
            def wrapper(tensor_or_list, *args, **kwargs):
                torch.cuda.synchronize()
                t = time.perf_counter()
                res = fn(tensor_or_list, *args, **kwargs)
                torch.cuda.synchronize()
                c = coll.setdefault(name, {"calls": 0, "ms": 0.0, "MB": 0.0})
                t_in = args[0] if name == "all_gather" else tensor_or_list
                c["calls"] += 1
                c["ms"] += (time.perf_counter() - t) * 1e3
                c["MB"] += t_in.numel() * t_in.element_size() / 2**20
                return res
            return wrapper

        dist.all_reduce = timed("all_reduce", dist.all_reduce)
        dist.all_gather = timed("all_gather", dist.all_gather)
        torch.cuda.reset_peak_memory_stats()
        fa.attention_fwd.launches = fa.attention_bwd.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = step(state, x, y)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t) * 1e3
        out = {"launches": {"B1": fa.attention_fwd.launches, "B2": fa.attention_bwd.launches},
               "collectives": {k: dict(v) for k, v in coll.items()}, "step_ms": step_ms,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "digest": state_digest(state)}
        if rank == 0:
            out["metrics"] = {k: v for k, v in m.items() if not k.startswith("_")}
            out["grads"] = {f"{net}.{k}": v.cpu() for net in ("G", "D")
                            for k, v in m[f"_grads_{net}"].items()}
        del state, step, m
        torch.cuda.empty_cache()

        state = place_state(phase11c_state(torch), mesh)
        x, y = host_local_batch(mesh, job["x11c"].cuda(), job["y11c"].cuda())
        step = make_sharded_train_step(state.G, state.D, OPTION_CONFIGS["10b reference parity"],
                                       mesh, draw_schedule=[to_cuda(i) for i in job["schedule11c"]],
                                       capture_grads=True)
        with SiteCounter(fa) as sites:
            sites.D = state.D
            torch.cuda.synchronize()
            t = time.perf_counter()
            m = step(state, x, y)
            torch.cuda.synchronize()
            c = {"step_ms": (time.perf_counter() - t) * 1e3, "sites": by_site(sites.take()),
                 "digest": state_digest(state)}
        if rank == 0:
            c["metrics"] = {k: v for k, v in m.items() if not k.startswith("_")}
            c["grads"] = {f"{net}.{k}": v.cpu() for net in ("G", "D")
                          for k, v in m[f"_grads_{net}"].items()}
        out["11c"] = c
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase11_gap(np, got, want):
    """A pair of steps read as phase 5 reads fused against plain: the
    metrics' max relative difference and whether each is within phase 5's
    bound, and per network the per-leaf gradient error's max and median (a
    leaf null in ``want`` and not in ``got`` counts as infinitely off)."""
    keys = list(want["metrics"])
    if set(got["metrics"]) != set(keys):
        raise SystemExit(f"11b: metrics {sorted(got['metrics'])} against {sorted(keys)}")
    gap = {"metrics": max(abs(got["metrics"][k] - want["metrics"][k])
                          / max(abs(want["metrics"][k]), 1e-12) for k in keys),
           "metrics_ok": all(abs(got["metrics"][k] - want["metrics"][k])
                             <= STEP_METRIC_ATOL + STEP_METRIC_RTOL * abs(want["metrics"][k])
                             for k in keys)}
    errs = {}
    for name, w in want["grads"].items():
        g, w = got["grads"][name].double(), w.double()
        if float(w.norm()) < 1e-5:  # null in exact arithmetic: must stay null
            if float(g.norm()) >= 1e-5:
                errs[name] = float("inf")
            continue
        errs[name] = float((g - w).norm()) / float(w.norm())
    for net in ("G", "D"):
        vals = [v for k, v in errs.items() if k.startswith(net + ".")]
        gap[net] = (max(vals), float(np.median(vals)))
    return gap


def phase11_within(gap):
    """Phase 5's bounds on the metrics, both networks' per-leaf max and D's
    median; G's median within ``PHASE11_G_MEDIAN``."""
    return (gap["metrics_ok"] and gap["G"][0] < STEP_GRAD_MAX and gap["D"][0] < STEP_GRAD_MAX
            and gap["D"][1] < STEP_GRAD_MEDIAN and gap["G"][1] < PHASE11_G_MEDIAN)


def phase11_line(label, gap, part="11b"):
    return (f"{part} {label}: metrics max rel diff {gap['metrics']:.3e}; per-leaf gradient error "
            f"G max {gap['G'][0]:.3e} median {gap['G'][1]:.3e}, D max {gap['D'][0]:.3e} median "
            f"{gap['D'][1]:.3e}")


def phase11_singles(torch, np, x, y, schedule):
    """11b's single-process steps: both events, both with BN summed by
    event (the yardstick), rank 0's event alone (the control)."""
    t = time.perf_counter()
    both = phase11_single(torch, x, y, schedule)
    by_event = phase11_single(torch, x, y, schedule, split_moments=True)
    rows = slice(0, 40)
    alone = phase11_single(torch, x[rows], y[rows], event0_schedule(schedule),
                           keep_state=True)
    print(f"11b one process: 2 events, 2 events with BN summed by event, rank 0's event "
          f"alone: {time.perf_counter() - t:.1f} s; G's eval output for event 0 at a batch of "
          f"40 vs within the batch of 80: max abs {both['batch_rounding']:.3e}", flush=True)
    yardstick = phase11_gap(np, by_event, both)
    print(phase11_line("yardstick (printed, not a bound), one process with BN summed by event "
                       "vs at once", yardstick), flush=True)
    return both, alone, yardstick


def data_parallel_phase(np, ranks, singles):
    """Phase 11b's checks: the two gloo ranks' results (``phase11_rank``)
    against one process taking both events and, the control, one event
    alone (``singles``, from ``phase11_singles``)."""
    both, alone, yardstick = singles
    for r, res in enumerate(ranks):
        print(f"11b rank {r}: step {res['step_ms']:.1f} ms (collectives timed between "
              f"synchronizations), B1 {res['launches']['B1']}, B2 {res['launches']['B2']} "
              f"launches, peak {res['peak_gib']:.2f} GiB, gloo " + json.dumps(
                  {k: {"calls": v["calls"], "ms": round(v["ms"], 1), "MB": round(v["MB"], 1)}
                   for k, v in res["collectives"].items()}), flush=True)
        if (res["launches"]["B1"], res["launches"]["B2"]) != (B1_PER_STEP, B2_PER_STEP):
            raise SystemExit(f"11b rank {r}: B1/B2 launched {res['launches']}, expected "
                             f"{(B1_PER_STEP, B2_PER_STEP)}")
    differ = [k for k, v in ranks[0]["digest"].items()
              if any(res["digest"].get(k) != v for res in ranks[1:])]
    if differ or any(set(res["digest"]) != set(ranks[0]["digest"]) for res in ranks):
        raise SystemExit(f"11b: the ranks' states differ at {differ[:5]} ({len(differ)} tensors)")
    print(f"11b: the {PHASE11_RANKS} ranks' states are bit-equal ({len(ranks[0]['digest'])} "
          "tensors and counts)", flush=True)
    gap = phase11_gap(np, ranks[0], both)
    print(phase11_line(f"{PHASE11_RANKS} ranks vs one process on both events", gap) + (
        f" (bounds: metrics rtol {STEP_METRIC_RTOL}, max {STEP_GRAD_MAX}, D median "
        f"{STEP_GRAD_MEDIAN}, G median {PHASE11_G_MEDIAN})"), flush=True)
    if not phase11_within(gap):
        raise SystemExit("11b: the data-parallel step disagrees with the single process")
    control = phase11_gap(np, ranks[0], alone)
    print(phase11_line("control, vs one process on rank 0's event alone (must break the "
                       "bounds)", control), flush=True)
    if phase11_within(control):
        raise SystemExit("11b: the control is within the bounds")
    ranks[0]["gap"], ranks[0]["yardstick"] = gap, yardstick
    return ranks[0]


def reference_parity_phase(np, ranks, single):
    """Phase 11c's checks: the ranks' launches by site, their states
    bit-equal, rank 0 against one process taking both events (11b's
    bounds)."""
    for r, res in enumerate(ranks):
        got = res["11c"]["sites"]
        print(f"11c rank {r}: step {res['11c']['step_ms']:.1f} ms, launches by site "
              + json.dumps({f"{k} {s_}": n for (k, s_), n in sorted(got.items())}), flush=True)
        if got != PHASE11C_LAUNCHES:
            raise SystemExit(f"11c rank {r}: launches {got}, expected {PHASE11C_LAUNCHES}")
    digests = [res["11c"]["digest"] for res in ranks]
    differ = [k for k, v in digests[0].items() if any(d.get(k) != v for d in digests[1:])]
    if differ or any(set(d) != set(digests[0]) for d in digests):
        raise SystemExit(f"11c: the ranks' states differ at {differ[:5]} ({len(differ)} tensors)")
    gap = phase11_gap(np, ranks[0]["11c"], single)
    print(phase11_line(f"{PHASE11_RANKS} ranks vs one process on both events", gap, "11c")
          + f"; the ranks' states bit-equal ({len(digests[0])} tensors and counts)", flush=True)
    if not phase11_within(gap):
        raise SystemExit("11c: the reference-parity step over two ranks disagrees with the "
                         "single process")
    return ranks[0]["11c"]


def parallel_phase(torch, np):
    """Phase 11: 11a through torchrun on NCCL; beside its resume, 11b's
    single-process steps and its two gloo ranks' set-up (spawn, restore,
    state broadcast); then the ranks' step, alone on the card."""
    import multiprocessing
    import tempfile

    x, y, schedule = phase11_inputs(torch)
    x11c, y11c, schedule11c = phase11c_inputs(torch)
    with tempfile.TemporaryDirectory() as tmp:
        job = os.path.join(tmp, "job.pt")
        torch.save({"x": x, "y": y, "schedule": schedule, "x11c": x11c, "y11c": y11c,
                    "schedule11c": schedule11c}, job)
        ctx = multiprocessing.get_context("spawn")
        go = ctx.Event()
        procs = [ctx.Process(target=phase11_rank, args=(r, PHASE11_RANKS,
                                                        os.path.join(tmp, "init"), job, tmp, go))
                 for r in range(PHASE11_RANKS)]

        def alongside():
            for p in procs:
                p.start()
            return (phase11_singles(torch, np, x, y, schedule),
                    phase11c_single(torch, x11c, y11c, schedule11c))

        try:
            t0 = time.perf_counter()
            entry_ms, (singles, single11c) = parallel_entry_point(np, alongside)
            phase("11a torchrun NCCL, with 11b's single process and the ranks' set-up beside "
                  "the resume", t0)
            t0 = time.perf_counter()
            go.set()
            for p in procs:
                p.join(400)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        if [p.exitcode for p in procs] != [0] * PHASE11_RANKS:
            raise SystemExit(f"11b: rank exit codes {[p.exitcode for p in procs]}")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(PHASE11_RANKS)]
    print(f"11b and 11c, two gloo ranks on one card: {time.perf_counter() - t0:.1f} s from the "
          "signal to step (11b's step; 11c's set-up, state broadcast and step; the states' "
          "digests; the results written)", flush=True)
    rank0 = data_parallel_phase(np, ranks, singles)
    rank0["11c"] = reference_parity_phase(np, ranks, single11c)
    phase("11b and 11c, two gloo ranks", t0)
    # phase 14 takes rank 0's event and its one-process step (the control here)
    return entry_ms, rank0, (x[:40], y[:40], event0_schedule(schedule), singles[1])


# Phase 14: tensor parallelism (the mesh's model axis) at the flagship
# width. Two gloo ranks share the one card (NCCL refuses two ranks on one
# device) on a 1x2 mesh, each holding its half of every leaf the JAX rule
# splits (G 112 column and 2 row leaves, D 44 and 3) in the parameters,
# G_ema and both Adam moments; from copy16000, f32 with TF32 off, one step on
# 11b's rank 0 event and draws, against 11b's one-process step on that event
# (phase 11's bounds: metrics, per-leaf gradient max of G and D, D's median
# at STEP_GRAD_MEDIAN, G's at PHASE11_G_MEDIAN; the Adam moments mu and
# sqrt(nu) per leaf as the gradients; every parameter element where each
# side's own moments put it, adam_residual). The replicated leaves must be
# bit-equal on both ranks, and each rank's bytes of the split leaves half
# the whole. Launches per rank by shape: B1 at RR_G in both G passes, at
# RR_D and D SA in D's three passes; B2 at D SA in all three D passes, RR_D
# in the D phase's real pass and the G phase, RR_G in the G phase, each at
# the rank's share of the heads (RR_G 1 of 2, RR_D 2 of 4) or of v's
# channels (D SA 64 of 128).
PHASE14_MESH = (1, 2)
PHASE14_LAUNCHES = {("B1", (1, 40, 40, 64, 64)): 2, ("B1", (2, 40, 40, 128, 128)): 3,
                    ("B1", (40, 3072, 768, 32, 64)): 3, ("B2", (1, 40, 40, 64, 64)): 1,
                    ("B2", (2, 40, 40, 128, 128)): 2, ("B2", (40, 3072, 768, 32, 64)): 3}


def phase14_rank(rank, world, init_file, job_path, out_dir):
    """One rank of phase 14, spawned: gloo on the card, a 1x2 mesh, one f32
    step from copy16000 on the job's event and draws; saves its launches,
    step ms, peak memory, its bytes of the split leaves against their whole
    bytes, the digest of its state and (rank 0) the metrics, the gradients
    and the parameters and Adam moments gathered whole, as ``rank<r>.pt``."""
    import torch
    import torch.distributed as dist

    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    sys.path.insert(0, ROOT)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        import ieagan_torch.kernels.flash_attention as fa
        from ieagan_torch.core.mesh import make_mesh
        from ieagan_torch.parallel import tensor
        from ieagan_torch.parallel.sharding import (full_state, full_tensors,
                                                    make_sharded_train_step, place_state)
        from ieagan_torch.train.step import restore_train_state

        job = torch.load(job_path, weights_only=False)
        mesh = make_mesh(*PHASE14_MESH)
        state = place_state(restore_train_state(CHECKPOINT, "copy16000", device="cuda"), mesh)
        step = make_sharded_train_step(state.G, state.D, {}, mesh,
                                       draw_schedule=[to_cuda(i) for i in job["schedule"]],
                                       capture_grads=True)
        x, y = job["x"].cuda(), job["y"].cuda()
        torch.cuda.reset_peak_memory_stats()
        fa.attention_fwd.launches = fa.attention_bwd.launches = 0
        with SiteCounter(fa, attention_shape) as shapes:
            torch.cuda.synchronize()
            t = time.perf_counter()
            m = step(state, x, y)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t) * 1e3
        held, whole = 0, 0
        for net, opt in ((state.G, state.opt_G), (state.D, state.opt_D), (state.G_ema, None)):
            for _, layer in tensor.split_layers(net):
                tensors = [layer.weight] + ([] if opt is None else [
                    opt.state[layer.weight][k] for k in opt.moment_names])
                held += sum(t.numel() * t.element_size() for t in tensors)
                whole += sum(t.numel() * t.element_size() for t in tensors) * mesh.n_model
        out = {"launches": {"B1": fa.attention_fwd.launches, "B2": fa.attention_bwd.launches},
               "shapes": shapes.counts, "step_ms": step_ms,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "split_bytes": (held, whole), "digest": state_digest(state),
               "split": sorted(f"{net}.{n}.weight" for net in ("G", "D", "G_ema")
                               for n, _ in tensor.split_layers(getattr(state, net)))}
        grads = {net: full_tensors(getattr(state, net), m[f"_grads_{net}"], mesh)
                 for net in ("G", "D")}
        with full_state(state, mesh):
            whole_state = params_and_moments(state) if rank == 0 else None
        if rank == 0:
            out["metrics"] = {k: v for k, v in m.items() if not k.startswith("_")}
            out["grads"] = {f"{net}.{k}": v.cpu() for net in ("G", "D")
                            for k, v in grads[net].items()}
            out["tp_state"] = whole_state
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def per_leaf(np, got, want):
    """(max, median) per network of the per-leaf ||got - want|| / ||want||
    over the leaves with ||want|| >= 1e-5."""
    errs = {}
    for name, w in want.items():
        g, w = got[name].double(), w.double()
        if float(w.norm()) >= 1e-5:
            errs[name] = float((g - w).norm()) / float(w.norm())
    return {net: (max(v for k, v in errs.items() if k.startswith(net + ".")),
                  float(np.median([v for k, v in errs.items() if k.startswith(net + ".")])))
            for net in ("G", "D")}


def adam_residual(np, tp, one):
    """Per network, the largest ratio over the parameters' elements of
    |(p_tp - p_one) + lr (d_tp - d_one)| to its bound, f32 rounding of both
    parameters (4 eps |p| each) plus 1e-5 lr: ``d`` is Adam's direction that
    each side's own moments give after the first step from fresh moments,
    mu_hat / (sqrt(nu_hat) + eps). The moments are held per leaf to phase
    11's bounds, so this holds each parameter to the one process's through
    its own moments, where the update's sign is the rounding's wherever a
    gradient element is (element-wise gaps up to 2 lr)."""
    from ieagan_torch.core.config import DEFAULT_CONFIG as cfg
    f32 = np.float32
    out = {}
    for net in ("G", "D"):
        lr = float(f32(cfg[f"{net}_lr"]))
        bc1 = float(f32(1.0) - f32(cfg[f"{net}_B1"]))
        bc2 = float(f32(1.0) - f32(cfg[f"{net}_B2"]))
        eps = float(cfg["adam_eps"])
        worst = 0.0
        for k, p_one in one["params"].items():
            if not k.startswith(net + "."):
                continue
            d = [s["mu"][k].double().numpy() / bc1
                 / (np.sqrt(s["nu"][k].double().numpy() / bc2) + eps) for s in (tp, one)]
            p = [s["params"][k].double().numpy() for s in (tp, one)]
            bound = 4 * np.finfo(np.float32).eps * (np.abs(p[0]) + np.abs(p[1])) + 1e-5 * lr
            worst = max(worst, float(np.max(np.abs(p[0] - p[1] + lr * (d[0] - d[1])) / bound)))
        out[net] = worst
    return out


def tensor_parallel_phase(torch, np, inputs, dp_gap):
    """Phase 14: two gloo ranks on a 1x2 mesh against 11b's one-process
    step on rank 0's event (``inputs``: the event, its draws and that
    step); ``dp_gap`` is 11b's gap, printed beside. Returns rank 0's
    result."""
    import multiprocessing
    import tempfile

    x, y, schedule, alone = inputs
    world = PHASE14_MESH[0] * PHASE14_MESH[1]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        job = os.path.join(tmp, "job.pt")
        torch.save({"x": x, "y": y, "schedule": schedule}, job)
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=phase14_rank, args=(r, world, os.path.join(tmp, "init"),
                                                        job, tmp))
                 for r in range(world)]
        try:
            for p in procs:
                p.start()
            for p in procs:
                p.join(600)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        if [p.exitcode for p in procs] != [0] * world:
            raise SystemExit(f"14: rank exit codes {[p.exitcode for p in procs]}")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(world)]
    print(f"14 two gloo ranks on a 1x2 mesh: {time.perf_counter() - t0:.1f} s (spawn, "
          "restore, placement, one step, gathers)", flush=True)
    for r, res in enumerate(ranks):
        held, whole = res["split_bytes"]
        print(f"14 rank {r}: step {res['step_ms']:.1f} ms, peak {res['peak_gib']:.2f} GiB, "
              f"B1 {res['launches']['B1']}, B2 {res['launches']['B2']} launches; by shape "
              + json.dumps({f"{k} {'x'.join(map(str, s_))}": n
                            for (k, s_), n in sorted(res["shapes"].items())})
              + f"; split leaves {len(res['split'])}, {held / 2**20:.2f} of "
              f"{whole / 2**20:.2f} MiB", flush=True)
        if res["shapes"] != PHASE14_LAUNCHES:
            raise SystemExit(f"14 rank {r}: launches {res['shapes']}, expected "
                             f"{PHASE14_LAUNCHES}")
        if (res["launches"]["B1"], res["launches"]["B2"]) != (B1_PER_STEP, B2_PER_STEP):
            raise SystemExit(f"14 rank {r}: B1/B2 launched {res['launches']}")
        if held * PHASE14_MESH[1] != whole or len(res["split"]) != 2 * (112 + 2) + 44 + 3:
            raise SystemExit(f"14 rank {r}: split leaves {len(res['split'])}, bytes "
                             f"{held} of {whole}")
    split = set(ranks[0]["split"])
    leaf = lambda k: k[4:].rsplit(".", 1)[0] if k.startswith("opt_") else k
    replicated = [k for k in ranks[0]["digest"] if leaf(k) not in split]
    differ = [k for k in replicated if ranks[1]["digest"][k] != ranks[0]["digest"][k]]
    if differ or not [k for k in ranks[0]["digest"] if leaf(k) in split]:
        raise SystemExit(f"14: replicated leaves differ across the ranks at {differ[:5]}")
    gap = phase11_gap(np, ranks[0], alone)
    tp, one = ranks[0]["tp_state"], alone["tp_state"]
    moments = {m: per_leaf(np, {k: v.sqrt() if m == "nu" else v for k, v in tp[m].items()},
                           {k: v.sqrt() if m == "nu" else v for k, v in one[m].items()})
               for m in ("mu", "nu")}
    params = adam_residual(np, tp, one)
    print(phase11_line("1x2 ranks vs one process on the event", gap, "14")
          + "; moments per-leaf (max, median): mu " + json.dumps(
              {n: [f"{a:.3e}", f"{b:.3e}"] for n, (a, b) in moments["mu"].items()})
          + ", sqrt(nu) " + json.dumps(
              {n: [f"{a:.3e}", f"{b:.3e}"] for n, (a, b) in moments["nu"].items()})
          + "; params, the largest residual over its bound " + json.dumps(
              {n: f"{v:.3e}" for n, v in params.items()})
          + f"; {len(replicated)} replicated tensors bit-equal on both ranks", flush=True)
    print("14 against 11b's data-parallel gap (G median, D median): "
          f"{gap['G'][1]:.3e} / {dp_gap['G'][1]:.3e}, {gap['D'][1]:.3e} / {dp_gap['D'][1]:.3e}",
          flush=True)
    moments_ok = all(v[0] < STEP_GRAD_MAX and v[1] < (
        PHASE11_G_MEDIAN if net == "G" else STEP_GRAD_MEDIAN)
        for m in moments.values() for net, v in m.items())
    if not (phase11_within(gap) and moments_ok and all(v <= 1.0 for v in params.values())):
        raise SystemExit("14: the tensor-parallel step disagrees with the single process")
    ranks[0]["gap"] = gap
    return ranks[0]


# Phase 13: the user tools, each through its main(argv) as
# ``python -m ieagan_torch...`` runs it. The proof tools read 400 images of
# best0 (two generator calls of fid_gen_chunks 8 events); each FID carries
# the host's 2048-d sqrtm. The finetune runs 24 steps of 4 images of phase
# 9's PNG tree (80 images, 8 held out: two whole validation batches), f32
# with TF32 off. Its first step is held to the same step on the CPU: the
# loss within 1e-4 relative; Adam's update within 1e-3 relative per leaf on
# the elements whose gradient the two sides give the same sign, a magnitude
# of 1e-5 or more (1,000 times Adam's eps) and at least 10 times their
# difference, where the update is +-lr within 1e-4 on both sides; every
# element within twice the learning rate (a gradient whose sign the rounding
# decides takes Adam's whole step either way). The gradients are read
# against the same step's in f64 on the card: at 299x299 a batch-norm
# field's gradient sums ~10^5 terms that cancel, and the CPU's own f32 step
# is only ~1e-3 (median per leaf) from f64 there, so the card's f32 step is
# held to TOOLS_F32_RATIO times the CPU's distance from f64 (max and median
# per leaf); a control (the f64 gradient of another batch) must break it.
TOOLS_EVENTS, TOOLS_EVENTS_PER_CALL = 8, 4
# BigGAN-deep 256 (BigGANdeep.py's G_arch[256]; Brock et al.,
# arXiv:1809.11096 app. B) over the port's deploy config: G_ch 128, RGB,
# 1,000 classes, hier, SA at 64x64 over 512 channels, no RRM. Phase 15
# samples BIGGAN_DEEP_IMAGES a call (a deployment would take 128; phase 3's
# G_SA row is the attention at that batch).
BIGGAN_DEEP_256 = dict(G_ch=128, G_depth=2, resolution=256, H_base=1, n_classes=1000,
                       dim_z=128, shared_dim=128, hier=True, G_shared=True, G_attn="64",
                       attn_type="sa", output_channels=3, RRM_prx_G=False, rdof_dim=0,
                       prior_embed=False, BN_eps=1e-5, SN_eps=1e-6,
                       use_pallas_attention=True)
BIGGAN_DEEP_IMAGES = 8
TOOLS_FID_IMAGES = 400
TOOLS_FID_REL = 1e-6
TOOLS_FINETUNE = dict(steps=24, batch=4, lr=1e-4)
TOOLS_STEP_LOSS_RTOL, TOOLS_STEP_UPDATE_REL, TOOLS_F32_RATIO = 1e-4, 1e-3, 4.0


class Tee:
    """stdout that also keeps what is written."""

    def __init__(self, stream):
        self.stream, self.parts = stream, []

    def write(self, text):
        self.parts.append(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()


def run_tool(main, argv):
    """``main(argv)`` of a tool; returns its result and its stdout lines."""
    import contextlib
    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        result = main(argv)
    return result, "".join(tee.parts).splitlines()


def tools_production(torch, np, root, fwd):
    """13a: ``create_gan_digits`` from best0, 8 events at 4 a call into npz
    shards: the sha256 line, one shard of 8 events, B1's launches at RR_G
    (the producer's block is 4 chunks of 4 events, so 8 events take one
    block of 4 generator calls), events per second of the whole call."""
    import hashlib
    from ieagan_torch.deploy import create_gan_digits
    from ieagan_torch.utils.flax_msgpack import resolve_generator_checkpoint

    out = os.path.join(root, "digits")
    resolved = resolve_generator_checkpoint(CHECKPOINT, tag="best0")
    with open(resolved, "rb") as fp:
        digest = hashlib.sha256(fp.read()).hexdigest()
    fwd.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    n, lines = run_tool(create_gan_digits.main, [
        out, str(TOOLS_EVENTS), "--checkpoint", CHECKPOINT, "--tag", "best0",
        "--events-per-call", str(TOOLS_EVENTS_PER_CALL), "--seed", "0"])
    wall = time.perf_counter() - t
    launches = fwd.launches
    chunks = 4  # EventProducer's default, as the JAX producer's
    calls = -(-TOOLS_EVENTS // (TOOLS_EVENTS_PER_CALL * chunks)) * chunks
    shards = sorted(os.listdir(out))
    shard = np.load(os.path.join(out, shards[0])) if shards else None
    print(f"13a create_gan_digits: {n} events in {wall:.2f} s ({n / wall:.2f} events/s, "
          f"restore included), {len(shards)} shard(s), n_events "
          f"{None if shard is None else int(shard['n_events'])}; B1 {launches} launches at "
          f"RR_G for {calls} generator calls", flush=True)
    want = f"checkpoint {os.path.basename(resolved)} sha256: {digest}"
    if lines[0] != want or lines[-1] != f"produced {TOOLS_EVENTS} events -> {out}":
        raise SystemExit(f"create_gan_digits printed {lines[0]!r} ... {lines[-1]!r}")
    if not (n == TOOLS_EVENTS and shards == ["events_00000.npz"]
            and int(shard["n_events"]) == TOOLS_EVENTS
            and all(len(shard[f"coords_{i}"]) == len(shard[f"charges_{i}"]) > 0
                    for i in range(TOOLS_EVENTS))):
        raise SystemExit(f"create_gan_digits: {n} events, shards {shards}")
    if launches != calls:
        raise SystemExit(f"create_gan_digits: B1 launched {launches} times for {calls} calls")
    return {"events_per_s": n / wall, "launches": launches}


def tools_stats(torch, np, tree):
    """13b: ``mint_stats --host-resize`` on phase 9's PNG tree equals phase
    9's ``make_custom_stats``/``make_custom_kid_stats`` (the fallback
    weights, host resize) on the same tree."""
    from ieagan_torch.eval import fid, mint_stats

    extractor = fid.FeatureExtractor(device="cuda")
    want = {"fid": fid.make_custom_stats("phase9", tree, extractor=extractor),
            "kid": fid.make_custom_kid_stats("phase9", tree, extractor=extractor)}
    t = time.perf_counter()
    paths, _ = run_tool(mint_stats.main, ["pngtree", tree, "--host-resize"])
    mint_s = time.perf_counter() - t
    worst = 0.0
    for kind in ("fid", "kid"):
        got, ref = np.load(paths[kind]), np.load(want[kind])
        if sorted(got.files) != sorted(ref.files):
            raise SystemExit(f"mint_stats {kind}: keys {got.files}, phase 9's {ref.files}")
        for key in ref.files:
            if got[key].shape != ref[key].shape:
                raise SystemExit(f"mint_stats {kind} {key}: shape {got[key].shape}")
            worst = max(worst, float(np.abs(got[key] - ref[key]).max()
                                     / np.abs(ref[key]).max()))
    print(f"13b mint_stats on phase 9's tree ({len(np.load(paths['kid'])['feats'])} images): "
          f"{mint_s:.2f} s; against phase 9's make_custom_stats, largest difference "
          f"{worst:.3e} of the largest entry (bound 1e-6)", flush=True)
    if not worst <= 1e-6:
        raise SystemExit("mint_stats disagrees with make_custom_stats")
    return mint_s


def tools_run_dir(root):
    """A run dir in the driver's layout holding best0 as G_ema_best0, its
    config the flagship's with the FID test's dataset set to phase 9's tree."""
    from ieagan_torch.core.config import DEFAULT_CONFIG
    run = os.path.join(root, "run_best0")
    os.makedirs(os.path.join(run, "weights"))
    os.symlink(os.path.join(CHECKPOINT, "G_ema_best0.msgpack"),
               os.path.join(run, "weights", "G_ema_best0.msgpack"))
    with open(os.path.join(run, "2000-01-01-00-00-00_config.json"), "w") as fp:
        json.dump(dict(DEFAULT_CONFIG, fid_dataset_name="pngtree", seed=0), fp)
    return run


def tools_proof(torch, np, run, fwd):
    """13c-d: ``moments_check`` then ``kid_eval`` on the run dir at 400
    images against 13b's stats: the JSON lines' keys, ``kid_eval``'s FID
    equal to ``moments_check``'s host FID within 1e-6 relative (the same
    seed, images and host path), the device moments' FID beside it;
    ``kid_eval``'s seconds by part and its B1 launches."""
    from ieagan_torch.eval import kid_eval, moments_check

    argv = ["--run-dir", run, "--tag", "best0", "--num", str(TOOLS_FID_IMAGES)]
    t = time.perf_counter()
    mom, lines = run_tool(moments_check.main, argv)
    mom_s = time.perf_counter() - t
    if json.loads(lines[-1]) != mom or list(mom) != ["fid_device_f32", "fid_host_f64",
                                                     "rel_diff", "num"]:
        raise SystemExit(f"moments_check printed {lines[-1]!r}")
    fwd.launches = 0
    t = time.perf_counter()
    kid, lines = run_tool(kid_eval.main, argv)
    kid_s = time.perf_counter() - t
    launches = fwd.launches
    line = json.loads(lines[-1])
    if list(line) != ["tag", "num", "fid", "kid_x1e3", "kid_floor_x1e3", "dataset"] or any(
            line[k] != kid[k] for k in line):
        raise SystemExit(f"kid_eval printed {lines[-1]!r}")
    gap = abs(kid["fid"] - mom["fid_host_f64"]) / abs(mom["fid_host_f64"])
    secs = kid["seconds"]
    print(f"13c moments_check: {json.dumps(mom)} in {mom_s:.2f} s; 13d kid_eval: "
          f"{json.dumps(line)} in {kid_s:.2f} s (generation {secs['generation']:.2f}, "
          f"features {secs['features']:.2f}, host f64 sqrtm {secs['sqrtm']:.2f}, KID "
          f"{secs['kid']:.2f}); kid_eval's FID against moments_check's host FID "
          f"{gap:.3e} relative (bound {TOOLS_FID_REL}); B1 {launches} launches in kid_eval, "
          "bf16", flush=True)
    if not (mom["num"] == line["num"] == TOOLS_FID_IMAGES and np.isfinite(
            [mom["fid_device_f32"], mom["fid_host_f64"], line["kid_x1e3"],
             line["kid_floor_x1e3"]]).all() and line["fid"] > 0):
        raise SystemExit("the proof tools' numbers are not finite")
    if not gap <= TOOLS_FID_REL:
        raise SystemExit("kid_eval's FID differs from moments_check's host FID")
    if launches == 0:
        raise SystemExit("kid_eval launched no B1")
    return {"kid_s": kid_s, "seconds": secs, "rel_diff": mom["rel_diff"],
            "launches": launches}


def inception_trunk(features, x):
    """``InceptionV3Features.forward`` in ``x``'s type (the module casts to
    f32): the f64 yardstick of phase 13e."""
    from ieagan_torch.eval.inception import max_pool3s2
    x = features.Conv2d_2b_3x3(features.Conv2d_2a_3x3(features.Conv2d_1a_3x3(x)))
    x = max_pool3s2(features.Conv2d_4a_3x3(features.Conv2d_3b_1x1(max_pool3s2(x))))
    for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                 "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
        x = getattr(features, name)(x)
    return x.mean(dim=(2, 3))


def finetune_first_step(torch, np, tree):
    """The finetune's first step on the card and on the CPU from one init on
    the same batch, its gradients against the step's in f64 (13e's bounds)."""
    import copy
    from ieagan_torch.eval import finetune_inception as ft
    from ieagan_torch.eval.fid import f32_products
    from ieagan_torch.train.optim import OptaxAdam

    imgs, labels, n_classes = ft.load_raw_images(tree, 2)
    imgs, labels = torch.from_numpy(imgs), torch.from_numpy(labels)
    train_idx, _ = ft.split(len(imgs), 0.1, 0)
    batch = TOOLS_FINETUNE["batch"]
    idx, other = (torch.as_tensor(train_idx[i * batch:(i + 1) * batch]) for i in (0, 1))
    lr = ft.cosine_decay(TOOLS_FINETUNE["lr"], TOOLS_FINETUNE["steps"])
    res = {}
    init = ft.build_classifier(n_classes, 0, None, "cpu")  # one init for every side
    before = {k: p.detach().clone() for k, p in init.named_parameters()}
    with f32_products():
        for device in ("cuda", "cpu"):
            model = copy.deepcopy(init).to(device)
            opt = OptaxAdam(model.parameters(), **ft.ADAM)
            metrics = ft.train_step(model, opt, imgs.to(device), labels.to(device),
                                    idx.to(device), lr)
            res[device] = (float(metrics[0]), before, {
                k: (p.detach().cpu(), p.grad.cpu()) for k, p in model.named_parameters()})
            del model, opt
        model = init.to("cuda").double()
        for name, rows in (("f64", idx), ("control", other)):
            x, y = ft.batch_from_idx(imgs.cuda(), labels.cuda(), rows.cuda())
            model.zero_grad()
            loss = torch.nn.functional.cross_entropy(
                model.fc(inception_trunk(model.features, x.double())), y.long())
            loss.backward()
            res[name] = (loss.item(), {k: p.grad.cpu() for k, p in model.named_parameters()})
        del model
    (loss_gpu, before, gpu), (loss_cpu, _, cpu) = res["cuda"], res["cpu"]

    def per_leaf(got, want):
        gaps = {k: float((got[k].double() - w).norm() / w.norm()) for k, w in want.items()
                if float(w.norm()) > 0}
        return max(gaps.values()), float(np.median(list(gaps.values()))), max(gaps, key=gaps.get)

    grads = {name: {k: g for k, (_, g) in side.items()} for name, side in (("gpu", gpu),
                                                                           ("cpu", cpu))}
    gpu64, cpu64 = (per_leaf(grads[n], res["f64"][1]) for n in ("gpu", "cpu"))
    control = per_leaf(grads["gpu"], res["control"][1])
    loss_gap = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    update_gap, element_gap, flipped, total = 0.0, 0.0, 0, 0
    for k, (p_cpu, g_cpu) in cpu.items():
        p_gpu, g_gpu = gpu[k]
        live = ((g_gpu * g_cpu > 0) & (g_cpu.abs() >= 1e-5)
                & (g_cpu.abs() >= 10 * (g_gpu - g_cpu).abs()))
        flipped += int((g_gpu * g_cpu < 0).sum())
        total += g_cpu.numel()
        d_gpu, d_cpu = (p_gpu - before[k])[live], (p_cpu - before[k])[live]
        if live.any():
            update_gap = max(update_gap, float((d_gpu - d_cpu).norm() / d_cpu.norm()))
        element_gap = max(element_gap, float((p_gpu - p_cpu).abs().max()))
    print(f"13e first finetune step, card against CPU ({len(cpu)} leaves, batch {batch}): loss "
          f"{loss_gpu:.6f} / {loss_cpu:.6f}, f64 {res['f64'][0]:.6f} ({loss_gap:.3e} "
          f"relative, bound {TOOLS_STEP_LOSS_RTOL}); gradient per leaf against the f64 step: "
          f"card f32 max {gpu64[0]:.3e} ({gpu64[2]}), median {gpu64[1]:.3e}; CPU f32 max "
          f"{cpu64[0]:.3e} ({cpu64[2]}), median {cpu64[1]:.3e} (bound: {TOOLS_F32_RATIO}x "
          f"the CPU's); control (another batch in f64) max {control[0]:.3e}, median "
          f"{control[1]:.3e}; {flipped} of {total} gradient elements of opposite sign on the "
          f"card and the CPU; Adam's update of the sign-settled elements per leaf max "
          f"{update_gap:.3e} (bound {TOOLS_STEP_UPDATE_REL}); any element {element_gap:.3e} "
          f"(bound {2 * lr(0):.1e})", flush=True)
    within = lambda a, b: a[0] <= TOOLS_F32_RATIO * b[0] and a[1] <= TOOLS_F32_RATIO * b[1]
    if not (loss_gap <= TOOLS_STEP_LOSS_RTOL and within(gpu64, cpu64)
            and update_gap <= TOOLS_STEP_UPDATE_REL and element_gap <= 2 * lr(0)):
        raise SystemExit("the finetune's first step on the card disagrees with the CPU's")
    if within(control, cpu64):
        raise SystemExit("the finetune step's control kept the bound: it cannot tell batches "
                         "apart")


def tools_finetune(torch, np, tree, root):
    """13e: ``finetune_inception`` on phase 9's tree from the fallback
    weights: the first step against the CPU's, then the whole run through
    ``main``; the written msgpack read back through ``load_inception_state``
    into ``FeatureExtractor`` equals the trained trunk, bit for bit, and
    gives finite features; ms per step and peak memory."""
    from ieagan_torch.eval import finetune_inception as ft
    from ieagan_torch.eval.fid import FeatureExtractor

    finetune_first_step(torch, np, tree)
    out = os.path.join(root, "inception_finetuned.msgpack")
    trained = {}
    write = ft.write_features

    def kept(model, path):  # observation only: keep the trunk that is written
        trained.update({k: v.detach().cpu().clone()
                        for k, v in model.features.state_dict().items()})
        write(model, path)

    ft.write_features = kept
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        res, lines = run_tool(ft.main, [
            "--dataroot", tree, "--out", out, "--steps", str(TOOLS_FINETUNE["steps"]),
            "--batch", str(TOOLS_FINETUNE["batch"]), "--lr", str(TOOLS_FINETUNE["lr"]),
            "--max-events", "2", "--val-frac", "0.1", "--seed", "0"])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        ft.write_features = write
    extractor = FeatureExtractor(out, device="cuda")
    same = all(torch.equal(v.cpu(), trained[k])
               for k, v in extractor.model.state_dict().items())
    feats = extractor.features(torch.rand((2, 3, 299, 299), device="cuda"))
    print(f"13e finetune_inception: {TOOLS_FINETUNE['steps']} steps of "
          f"{TOOLS_FINETUNE['batch']}: {res['step_ms']:.2f} ms per step (median of steps 2 "
          f"on, host clock after synchronize), peak {peak:.2f} GiB; last step loss/acc "
          f"{res['loss_acc']}; validation accuracy {res['val_acc']:.4f} over {res['n_val']} "
          f"images; the written backbone read back bit-equal: {same}, features finite: "
          f"{bool(torch.isfinite(feats).all())}", flush=True)
    if not (same and len(trained) == len(extractor.model.state_dict()) and res["n_val"] > 0
            and np.isfinite(res["loss_acc"]).all() and bool(torch.isfinite(feats).all())
            and lines[-1] == f"saved feature-extractor params to {out}"):
        raise SystemExit("finetune_inception's run or its backbone file failed its checks")
    return {"step_ms": res["step_ms"], "peak_gib": peak}


def tools_phase(torch, np):
    """Phase 13: the user tools through ``main(argv)``."""
    import tempfile
    from ieagan_torch.core.config import DEFAULT_CONFIG
    from ieagan_torch.kernels.flash_attention import attention_fwd

    out = {}
    stats_env = os.environ.get("IEAGAN_STATS_DIR")
    with tempfile.TemporaryDirectory() as root:
        os.environ["IEAGAN_STATS_DIR"] = os.path.join(root, "stats")
        try:
            t0 = time.perf_counter()
            out["production"] = tools_production(torch, np, root, attention_fwd)
            phase("13a create_gan_digits", t0)
            tree = write_png_tree(np, os.path.join(root, "pxd"), DEFAULT_CONFIG)
            t0 = time.perf_counter()
            out["mint_s"] = tools_stats(torch, np, tree)
            phase("13b mint_stats", t0)
            t0 = time.perf_counter()
            out["proof"] = tools_proof(torch, np, tools_run_dir(root), attention_fwd)
            phase("13c-d moments_check, kid_eval", t0)
            t0 = time.perf_counter()
            out["finetune"] = tools_finetune(torch, np, tree, root)
            phase("13e finetune_inception", t0)
        finally:
            if stats_env is None:
                os.environ.pop("IEAGAN_STATS_DIR", None)
            else:
                os.environ["IEAGAN_STATS_DIR"] = stats_env
    torch.cuda.empty_cache()
    return out


def biggan_deep_phase(torch, np):
    """Phase 15: BigGAN-deep 256 through ``sample_batched`` at the
    published widths, against the plain reference. Returns B1's launches a
    call and the median ms of a call."""
    import ieagan_torch.kernels.flash_attention as fa
    from ieagan_torch.deploy import Model, sample_batched
    from references import biggan_deep as ref

    n = BIGGAN_DEEP_IMAGES
    torch.cuda.reset_peak_memory_stats()
    model = Model(config=BIGGAN_DEEP_256, device="cuda", seed=14)
    attn = [name for name in model.G.layer_names if name.startswith("attn")]
    if attn != ["attn_3"] or model.G.attn_3.ch != 512:
        raise SystemExit(f"BigGAN-deep: G attention at {attn}, expected attn_3 over 512 channels")
    with torch.no_grad():
        model.G.attn_3.gamma.fill_(0.5)
    gen = torch.Generator(device="cuda").manual_seed(15)
    sample_batched(model, n, gen)        # the first call keeps every W/sigma
    torch.cuda.synchronize()
    state = gen.get_state()
    fa.attention_fwd.launches = 0
    out = sample_batched(model, n, gen)
    torch.cuda.synchronize()
    launches = fa.attention_fwd.launches
    if launches != 1:
        raise SystemExit(f"BigGAN-deep: B1 launched {launches} times in one sample_batched call")
    if tuple(out.shape) != (n, 256, 256, 3) or not bool(torch.isfinite(out).all()) \
            or float(out.abs().max()) > 1.0:
        raise SystemExit(f"BigGAN-deep: sample_batched gave {tuple(out.shape)}, "
                         f"|x| max {float(out.abs().max())}")
    replay = torch.Generator(device="cuda")
    replay.set_state(state)
    z, y = model.draw_images(n, replay)
    S = model.G.state_dict()
    with torch.no_grad():
        err = float((out - ref.generator(model.config, S, z, y)).abs().max())
        ctl = float((out - ref.generator(model.config, S, z, y, precision="bfloat16"))
                    .abs().max())
    print(f"15 BigGAN-deep 256 sample_batched({n}): {tuple(out.shape)}, B1 {launches} launch a "
          f"call, std {float(out.std()):.3f}; against the plain reference max abs diff "
          f"{err:.3e}, the reference in bfloat16 {ctl:.3e} (bound {FUSED_VS_PLAIN_ATOL})",
          flush=True)
    if not (err <= FUSED_VS_PLAIN_ATOL < ctl):
        raise SystemExit("BigGAN-deep: the program or the bfloat16 control against the bound")
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t = time.perf_counter()
        sample_batched(model, n, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    ms = sorted(times)[len(times) // 2]
    print(f"15 BigGAN-deep 256 sample_batched({n}): {ms:.2f} ms a call (median of 4, host clock "
          f"after synchronize), peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    del model, out, S
    torch.cuda.empty_cache()
    return launches, ms


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
    train_launches, step_ms, peak, first_step = train_path(torch, np)
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

    t0 = time.perf_counter()
    opt = options_phase(torch, np)
    phase("options at full width", t0)

    t0 = time.perf_counter()
    dp_entry_ms, dp_rank0, tp_inputs = parallel_phase(torch, np)
    phase("data parallel", t0)

    t0 = time.perf_counter()
    remat_gold, remat_max, remat_med = remat_golden(torch, np, first_step)
    del first_step
    phase("12a recompute against the golden step and phase 5", t0)
    t0 = time.perf_counter()
    remat_rows = remat_memory(torch, np, driver_ms, driver_peak)
    phase("12b recompute's memory and time", t0)

    t0 = time.perf_counter()
    tools = tools_phase(torch, np)
    phase("13 user tools", t0)

    t0 = time.perf_counter()
    tp_rank0 = tensor_parallel_phase(torch, np, tp_inputs, dp_rank0["gap"])
    del tp_inputs
    phase("14 tensor parallel", t0)

    t0 = time.perf_counter()
    biggan_launches, biggan_ms = biggan_deep_phase(torch, np)
    phase("15 BigGAN-deep 256", t0)

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
        "launches_dp_per_rank": dp_rank0["launches"]["B1"],
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
        "launches_dp_per_rank": dp_rank0["launches"]["B2"],
        "bf16": {"max_abs_err": max(b2h["max_abs_err_dq"], b2h["max_abs_err_dk"],
                                    b2h["max_abs_err_dv"]),
                 "ms": b2h["ms"], "plain_ms": b2h["plain_ms"], "bound_ms": b2h["bound_ms"],
                 "bound_by": b2h["bound_by"], "library_ms": b2h["library_ms"]},
    }]
    # Phase 10's sites: D's proxy RRM in the 256 instance (at 80, as the
    # reference-parity D phase gives it) and PEGAN's G attention (D SA's
    # shape); launches from one fused f32 step of 10b and from 10a's deploy.
    pick_site = lambda rs, site, shape, dtype="float32": next(
        r for r in rs if r["site"] == site and r["shape"] == shape and r["dtype"] == dtype)
    for kernel, rs, err_keys in (("B1", rows, ("max_abs_err_o",)),
                                 ("B2", bwd_rows, ("max_abs_err_dq", "max_abs_err_dk",
                                                   "max_abs_err_dv"))):
        r = pick_site(rs, "RR_Dproxy", [4, 80, 80, 256, 256])
        r16 = pick_site(rs, "RR_Dproxy", [4, 80, 80, 256, 256], "bfloat16")
        counts = {k: n for k, n in by_site(opt["10b reference parity"][0]["sites"]).items()
                  if k[0] == kernel and k[1].startswith("RR_Dproxy")}
        kernels.append({
            "name": f"attention_{'fwd' if kernel == 'B1' else 'bwd'} ({kernel}), 256 instance",
            "route": "cuda", "source": kernels[0 if kernel == "B1" else 1]["source"],
            "replaces": kernels[0 if kernel == "B1" else 1]["replaces"],
            "launches": sum(counts.values()),
            "max_abs_err": max(r[k] for k in err_keys), "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "site": "RR_Dproxy f32 4x80x80x256x256 (phase 10b, one f32 step)",
            "launches_by_site": {s_: n for (_, s_), n in counts.items()},
            "bf16": {"max_abs_err": max(r16[k] for k in err_keys), "ms": r16["ms"],
                     "plain_ms": r16["plain_ms"], "bound_ms": r16["bound_ms"],
                     "bound_by": r16["bound_by"], "library_ms": r16["library_ms"]}})
    # 11c's sites: the RRMs at one sequence of 160 over two ranks of one
    # event; launches per rank from 11c's step.
    for kernel, rs, err_keys in (("B1", rows, ("max_abs_err_o",)),
                                 ("B2", bwd_rows, ("max_abs_err_dq", "max_abs_err_dk",
                                                   "max_abs_err_dv"))):
        for site, width in (("RR_D", 128), ("RR_Dproxy", 256)):
            shape = [4, 160, 160, width, width]
            r, r16 = (pick_site(rs, site, shape, t) for t in ("float32", "bfloat16"))
            kernels.append({
                "name": f"attention_{'fwd' if kernel == 'B1' else 'bwd'} ({kernel}) at {site} L160"
                        + (", 256 instance" if width == 256 else ""),
                "route": "cuda", "source": kernels[0 if kernel == "B1" else 1]["source"],
                "replaces": kernels[0 if kernel == "B1" else 1]["replaces"],
                "launches": dp_rank0["11c"]["sites"].get((kernel, f"{site} L160"), 0),
                "max_abs_err": max(r[k] for k in err_keys), "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"],
                "site": f"{site} f32 " + "x".join(map(str, shape)) + " (phase 11c, per rank)",
                "bf16": {"max_abs_err": max(r16[k] for k in err_keys), "ms": r16["ms"],
                         "plain_ms": r16["plain_ms"], "bound_ms": r16["bound_ms"],
                         "bound_by": r16["bound_by"], "library_ms": r16["library_ms"]}})
    # Phase 13's site: the generator's RRM through the user tools; launches
    # from create_gan_digits (f32, best0), kid_eval's beside them (bf16)
    r, r16 = (pick_site(rows, "RR_G", [2, 40, 40, 64, 64], t) for t in ("float32", "bfloat16"))
    kernels.append({
        "name": "attention_fwd (B1) at RR_G through the user tools", "route": "cuda",
        "source": kernels[0]["source"], "replaces": kernels[0]["replaces"],
        "launches": tools["production"]["launches"], "max_abs_err": r["max_abs_err_o"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "site": "RR_G f32 2x40x40x64x64 (phase 13a create_gan_digits, 8 events at 4 a call)",
        "launches_kid_eval": tools["proof"]["launches"],
        "bf16": {"max_abs_err": r16["max_abs_err_o"], "ms": r16["ms"],
                 "plain_ms": r16["plain_ms"], "bound_ms": r16["bound_ms"],
                 "bound_by": r16["bound_by"], "library_ms": r16["library_ms"]}})
    # Phase 14's sites: each rank's share of the heads or of v's channels
    # on a 1x2 mesh; launches per rank from its step.
    for kernel, rs, err_keys in (("B1", rows, ("max_abs_err_o",)),
                                 ("B2", bwd_rows, ("max_abs_err_dq", "max_abs_err_dk",
                                                   "max_abs_err_dv"))):
        for site, b, lq, lkv, dk, dv, _ in TP_SITES:
            shape = [b, lq, lkv, dk, dv]
            r, r16 = (pick_site(rs, site, shape, t) for t in ("float32", "bfloat16"))
            kernels.append({
                "name": f"attention_{'fwd' if kernel == 'B1' else 'bwd'} ({kernel}) at {site}, "
                        "tensor parallel",
                "route": "cuda", "source": kernels[0 if kernel == "B1" else 1]["source"],
                "replaces": kernels[0 if kernel == "B1" else 1]["replaces"],
                "launches": tp_rank0["shapes"].get((kernel, tuple(shape)), 0),
                "max_abs_err": max(r[k] for k in err_keys), "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"],
                "site": f"{site} f32 " + "x".join(map(str, shape)) + " (phase 14, per rank of "
                        "a 1x2 mesh)",
                "bf16": {"max_abs_err": max(r16[k] for k in err_keys), "ms": r16["ms"],
                         "plain_ms": r16["plain_ms"], "bound_ms": r16["bound_ms"],
                         "bound_by": r16["bound_by"], "library_ms": r16["library_ms"]}})
    # Phase 15's site at a deployment's 128 images: the (64, 256) instance,
    # beside the (256, 256) route it replaced; launches from one call.
    r, r16 = (pick_site(rows, "G_SA", [128, 4096, 1024, 64, 256], t)
              for t in ("float32", "bfloat16"))
    kernels.append({
        "name": "attention_fwd (B1), (64, 256) instance, at BigGAN-deep's G attention",
        "route": "cuda", "source": kernels[0]["source"], "replaces": kernels[0]["replaces"],
        "launches": biggan_launches, "max_abs_err": r["max_abs_err_o"], "ms": r["ms"],
        "route_256_ms": r["route_256_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "site": "G_SA f32 128x4096x1024x64x256 (phase 15: one launch a sample_batched call)",
        "bf16": {"max_abs_err": r16["max_abs_err_o"], "ms": r16["ms"],
                 "route_256_ms": r16["route_256_ms"], "plain_ms": r16["plain_ms"],
                 "bound_ms": r16["bound_ms"], "bound_by": r16["bound_by"],
                 "library_ms": r16["library_ms"]}})
    kernels.append({
        "name": "attention_fwd (B1) at PEGAN's G attention", "route": "cuda",
        "source": kernels[0]["source"], "replaces": kernels[0]["replaces"],
        "launches": opt["deploy_launches"], "max_abs_err": b1["max_abs_err_o"], "ms": b1["ms"],
        "plain_ms": b1["plain_ms"], "bound_ms": b1["bound_ms"], "bound_by": b1["bound_by"],
        "library_ms": b1["library_ms"],
        "site": "G SA f32 40x3072x768x32x128 (D_SA's shape; phase 10a deploy, 2 generator calls)"})
    print(f"phase 10: PEGAN {opt['pegan_ms_per_event'][1]:.2f} / "
          f"{opt['pegan_ms_per_event'][4]:.2f} ms per event (1 / 4 events per call); f32 / bf16 "
          "ms per step: " + "; ".join(
              f"{n} {sum(opt[n][1]) / len(opt[n][1]):.1f} / {sum(opt[n][2]) / len(opt[n][2]):.1f}"
              for n in ("10a PEGAN", "10b reference parity"))
          + f"; 10c Proj f32 {sum(opt['10c Proj']) / len(opt['10c Proj']):.1f}", flush=True)
    print(f"phase 11: torchrun --mesh 1 bf16 step {dp_entry_ms:.1f} ms (phase 7's driver step "
          f"{driver_ms:.1f} ms); 11b rank 0 f32 step over gloo {dp_rank0['step_ms']:.1f} ms, "
          f"peak {dp_rank0['peak_gib']:.2f} GiB; 11c rank 0 {dp_rank0['11c']['step_ms']:.1f} ms",
          flush=True)
    print(f"phase 12: golden step with remat=True " + json.dumps(remat_gold) + f"; against phase "
          f"5's step without, gradient per-leaf max {remat_max:.3e}, median {remat_med:.3e}; "
          "bf16 driver step (events, remat: peak GiB, ms per step): " + "; ".join(
              f"{r['events']}, {r['remat']}: {r['peak_gib']:.2f}, "
              + "/".join(f"{t:.1f}" for t in r["ms"]) for r in remat_rows), flush=True)
    secs = tools["proof"]["seconds"]
    print(f"phase 13: create_gan_digits {tools['production']['events_per_s']:.2f} events/s "
          f"(B1 {tools['production']['launches']} launches at RR_G); kid_eval of "
          f"{TOOLS_FID_IMAGES} images {tools['proof']['kid_s']:.2f} s (generation "
          f"{secs['generation']:.2f}, features {secs['features']:.2f}, sqrtm "
          f"{secs['sqrtm']:.2f}); moments_check rel_diff {tools['proof']['rel_diff']:.3e}; "
          f"finetune_inception {tools['finetune']['step_ms']:.2f} ms per step of "
          f"{TOOLS_FINETUNE['batch']}, peak {tools['finetune']['peak_gib']:.2f} GiB", flush=True)
    print(f"phase 14: 1x2 mesh over gloo on one card, rank 0 f32 step "
          f"{tp_rank0['step_ms']:.1f} ms, peak {tp_rank0['peak_gib']:.2f} GiB; gap from one "
          f"process: G median {tp_rank0['gap']['G'][1]:.3e}, D median "
          f"{tp_rank0['gap']['D'][1]:.3e}", flush=True)
    print(f"phase 15: BigGAN-deep 256 sample_batched({BIGGAN_DEEP_IMAGES}) {biggan_ms:.2f} ms a "
          f"call, B1 {biggan_launches} launch a call", flush=True)
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
