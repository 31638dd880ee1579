"""Traffic kind ``train``: the program's train step called back to back, as
``ieagan_torch/train/driver.py::run`` builds it
(``parallel/sharding.py::make_sharded_train_step`` without a mesh, over the
state of ``train/step.py::init_train_state``), ``events_per_step`` events a
step.

Parameters (``traffic/<mix>.json``): ``events_per_step``, ``batches`` (the
number of distinct real batches, cycled), ``checked_steps`` (the first steps,
run in set-up, that the reference follows), ``trace_steps``.

Set-up makes G's and D's state from the seed (``harness/weights.py``) and
loads it into the state, G_ema included; the reals are images uniform in
[-1, 1] drawn on the device, each event's labels a permutation of the
classes; every draw of the step (z, rdof, DiffAugment's) comes from the
benchmark's own ``torch.Generator`` through the step's ``draw_schedule``,
in the order the step takes them. The first ``checked_steps`` steps run
through the same step object as the window; the optimisers' first moments
after step 1 (the gradients they got) and the parameters after the last of
them are kept. Once the window has closed and the program is freed, the
plain reference (``reference/step.py``, float32 products, TF32 off, each
block recomputed in the backward so that it fits) takes the same steps, and
``compare.py``'s gaps hold them: ``loss_gap`` the first step's losses,
``grad_gap`` and ``update_gap`` the median leaf's gap of G's and D's (and
G_ema's) whichever net reads higher. A cell compares those its
``limits`` name; the others are printed. The worst leaf's gaps and the
later steps' losses are printed beside them; they swing with the noise of
single small leaves and of the later steps (PERF.md).
"""

from __future__ import annotations

import math
import time

from benchmark.harness import compare, weights
from benchmark.harness.run_state import Check, subseed
from benchmark.reference import model as ref
from benchmark.reference import step as ref_step
from benchmark.work import attention, model_flops


class Draws:
    """The step's draws, made on the device from the benchmark's generator:
    per step the D phase's z (, rdof), the fakes' DiffAugment draws at the
    compute type's granularity and the reals' in float32, then the G
    phase's z (, rdof) and the fakes' draws. The first ``keep`` steps' draws
    are kept for the reference."""

    def __init__(self, cfg, seed, images, h, w, compute_dtype, device, keep):
        import torch
        self.torch, self.cfg, self.dev = torch, cfg, device
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.b, self.h, self.w = images, h, w
        self.fake_bits = (23 if compute_dtype == torch.float32
                          else round(-math.log2(torch.finfo(compute_dtype).eps)))
        self.order = self._order()
        self.keep, self.kept, self.i = keep, [], 0

    def _order(self):
        lat = ["z"] + (["rdof"] if self.cfg["RRM_prx_G"] else [])
        return lat + ["fake", "real"] + lat + ["fake"]

    def _uniform(self, bits):
        t = self.torch
        if bits >= 23:
            return t.rand((self.b,), generator=self.gen, device=self.dev)
        k = t.randint(0, 1 << bits, (self.b,), generator=self.gen, device=self.dev)
        return k.float() * 2.0 ** -bits

    def _aug(self, bits):
        t, b, h, w = self.torch, self.b, self.h, self.w
        sh, sw = int(h * 0.125 + 0.5), int(w * 0.125 + 0.5)
        ch, cw = int(h * 0.5 + 0.5), int(w * 0.5 + 0.5)
        ri = lambda lo, hi: t.randint(lo, hi, (b,), generator=self.gen, device=self.dev)
        return {"brightness": self._uniform(bits) - 0.5, "saturation": self._uniform(bits) * 2.0,
                "contrast": self._uniform(bits) + 0.5,
                "t_h": ri(-sh, sh + 1), "t_w": ri(-sw, sw + 1),
                "off_h": ri(0, h + (1 - ch % 2)), "off_w": ri(0, w + (1 - cw % 2))}

    def __iter__(self):
        return self

    def __next__(self):
        t = self.torch
        kind = self.order[self.i % len(self.order)]
        if kind == "z":
            item = t.randn((self.b, self.cfg["dim_z"]), generator=self.gen, device=self.dev)
        elif kind == "rdof":
            item = t.randn((self.b, self.cfg["rdof_dim"]), generator=self.gen, device=self.dev)
        else:
            item = self._aug(self.fake_bits if kind == "fake" else 23)
        if self.i < self.keep * len(self.order):
            self.kept.append({k: v.clone() for k, v in item.items()}
                             if isinstance(item, dict) else item.clone())
        self.i += 1
        return item

    def step_draws(self, step: int):
        n = len(self.order)
        return self.kept[step * n:(step + 1) * n]


def make_batches(cfg, seed, n_batches, events, device):
    """``n_batches`` distinct (x, y): images uniform in [-1, 1] and, per
    event, a permutation of the classes."""
    import torch
    es = cfg["n_classes"]
    h, w = cfg["resolution"], cfg["resolution"] * cfg["H_base"]
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand((n_batches, events * es, h, w, 1), generator=gen, device=device) * 2 - 1
    ys = [torch.cat([torch.randperm(es, generator=gen, device=device) for _ in range(events)])
          for _ in range(n_batches)]
    return [(x[i], ys[i]) for i in range(n_batches)]


class _Rows:
    """The draws cut to their first ``rows`` rows (the half-batch fault)."""

    def __init__(self, draws, rows):
        self.draws, self.rows = draws, rows

    def __iter__(self):
        return self

    def __next__(self):
        item = next(self.draws)
        if isinstance(item, dict):
            return {k: v[:self.rows] for k, v in item.items()}
        return item[:self.rows]


def _params(module):
    return {n: p.detach().clone() for n, p in module.named_parameters()}


def declare(r):
    """What a call of the cell is: a train step of ``events_per_step``
    events, its model FLOPs and its attention sites."""
    events = int(r.cell.traffic["events_per_step"])
    r.family, r.unit, r.units_per_call = "train", "images", events * r.config["n_classes"]
    r.flops_per_call = model_flops.train_step(r.config, events)
    r.attention_sites = attention.sites(r.config, "train", events)


def run(r, mode: str = "program", fault: str | None = None):
    """Drive the cell into ``r``. ``mode`` ``control`` puts the reference at
    the cell's control precision in the program's place; ``fault`` plants a
    fault in the timed path (tests): ``unchanged`` (the step leaves the
    state as it was), ``half_batch`` (the step sees half of the events, and
    the means run over them)."""
    import torch
    from ieagan_torch.core.precision import get_policy
    from ieagan_torch.models.discriminator import Discriminator
    from ieagan_torch.models.generator import Generator
    from ieagan_torch.parallel.sharding import make_sharded_train_step
    from ieagan_torch.train.step import init_train_state

    traffic, cfg, dev = r.cell.traffic, r.config, r.device
    declare(r)
    events = int(traffic["events_per_step"])
    es = cfg["n_classes"]
    checked = int(traffic["checked_steps"])
    r.phase("import")

    SG = weights.make(ref.g_spec(cfg), subseed(r.seed, "weights G"), dev)
    SD = weights.make(ref.d_spec(cfg), subseed(r.seed, "weights D"), dev)
    batches = make_batches(cfg, subseed(r.seed, "reals"), int(traffic["batches"]), events, dev)
    policy = get_policy(cfg["compute_dtype"])
    h, w = cfg["resolution"], cfg["resolution"] * cfg["H_base"]
    draws = Draws(cfg, subseed(r.seed, "draws"), events * es, h, w, policy.compute_dtype, dev,
                  keep=checked)
    r.phase("weights and reals")
    prog = {}   # the program's objects, freed before the reference runs
    if mode == "control":
        prog["trainer"] = ref_step.Trainer(cfg, SG, SD, ref.Ops(r.cell.workload["control"]),
                                           recompute=dev.type == "cuda")

        def step(x, y):
            return prog["trainer"].step(x, y, [next(draws) for _ in draws.order])[0]
    else:
        with torch.device(dev):
            G, D = Generator.from_config(cfg), Discriminator.from_config(cfg)
        state = init_train_state(G, D, cfg, torch.Generator(device=dev).manual_seed(
            subseed(r.seed, "init")), compute_dtype=policy.compute_dtype)
        G.load_state_dict(SG, strict=True)
        D.load_state_dict(SD, strict=True)
        state.G_ema.load_state_dict(SG, strict=True)
        rows = None if fault != "half_batch" else max(1, events // 2) * es
        schedule = draws if rows is None else _Rows(draws, rows)
        prog["state"] = state
        prog["step"] = make_sharded_train_step(G, D, cfg, None, draw_schedule=schedule)
        del G, D, state

        def step(x, y):
            if rows is not None:
                x, y = x[:rows], y[:rows]
            st = prog["state"]
            if fault == "unchanged":
                saved = [{k: v.clone() for k, v in m.state_dict().items()}
                         for m in (st.G, st.D, st.G_ema)]
            out = prog["step"](st, x, y, None)
            if fault == "unchanged":
                for m, sd in zip((st.G, st.D, st.G_ema), saved):
                    m.load_state_dict(sd)
            return out
    r.phase("train state (init_train_state, the weights loaded)")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # the checked steps: the same step object and feed as the window
    program_losses, grads1 = [], None
    for i in range(checked):
        program_losses.append(step(*batches[i % len(batches)]))
        if i == 0:
            grads1 = (_first_grads(prog["state"], cfg) if mode != "control" else
                      {n: _trainer_grads(prog["trainer"], n) for n in ("G", "D")})
    sync()
    if mode == "control":
        tr = prog["trainer"]
        after = {"G": dict(tr.pG), "D": dict(tr.pD), "G_ema": {k: tr.G_ema[k] for k in tr.pG}}
    else:
        st = prog["state"]
        after = {"G": _params(st.G), "D": _params(st.D), "G_ema": _params(st.G_ema)}
    after = {n: {k: v.cpu() for k, v in d.items()} for n, d in after.items()}
    grads1 = {n: {k: v.cpu() for k, v in d.items()} for n, d in grads1.items()}
    r.phase(f"first {checked} steps (checked)")

    limit_steps = int(traffic["trace_steps"]) if r.traced else None

    def window():
        import contextlib
        span_ = (torch.profiler.record_function if r.traced
                 else lambda name: contextlib.nullcontext())
        times, i = [], checked
        if r.traced:
            r.phase("profiler start")
        r.window_started()
        t_open = time.perf_counter()
        with span_("bench.window"):
            while True:
                t0 = time.perf_counter()
                with span_("bench.call"):
                    step(*batches[i % len(batches)])
                    sync()
                t1 = time.perf_counter()
                times.append(t1 - t0)
                i += 1
                if t1 - t_open >= r.seconds or (limit_steps and len(times) >= limit_steps):
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
    r.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0

    # the reference, once the program is freed
    prog.clear()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    reference = ref_step.Trainer(cfg, SG, SD, ref.Ops("float32"), recompute=dev.type == "cuda")
    ref_losses, ref_grads1 = [], None
    for i in range(checked):
        x, y = batches[i % len(batches)]
        mets, g_G, g_D = reference.step(x, y, draws.step_draws(i))
        ref_losses.append(mets)
        if i == 0:
            ref_grads1 = {"G": {k: v.cpu() for k, v in g_G.items()},
                          "D": {k: v.cpu() for k, v in g_D.items()}}
    ref_after = {"G": {k: v.cpu() for k, v in reference.pG.items()},
                 "D": {k: v.cpu() for k, v in reference.pD.items()},
                 "G_ema": {k: reference.G_ema[k].cpu() for k in reference.pG}}
    start = {"G": {k: v.cpu() for k, v in SG.items() if k in ref_after["G"]},
             "D": {k: v.cpu() for k, v in SD.items() if k in ref_after["D"]}}
    start["G_ema"] = start["G"]

    losses = compare.loss_gaps(program_losses, ref_losses)
    grads, updates = {}, {}
    for net in ("G", "D", "G_ema"):
        keep = compare.moving_leaves(ref_grads1["G" if net == "G_ema" else net])
        if net != "G_ema":
            grads[net] = compare.leaf_gaps(grads1[net], ref_grads1[net], keep)
        d_prog = {k: after[net][k] - start[net][k] for k in keep}
        d_ref = {k: ref_after[net][k] - start[net][k] for k in keep}
        updates[net] = compare.leaf_gaps(d_prog, d_ref, keep)
    step1 = {k: v for k, v in losses.items() if k.startswith("step 1 ")}
    grad_median = max(compare.median_gap(g) for g in grads.values())
    update_median = max(compare.median_gap(u) for u in updates.values())
    flat = lambda per_net: {f"{n} {k}": v for n, d in per_net.items() for k, v in d.items()}
    (w_loss, at_loss), (w_grad, at_grad), (w_upd, at_upd) = (
        compare.worst(losses), compare.worst(flat(grads)), compare.worst(flat(updates)))
    r.notes["compared"] = dict(
        steps=checked, worst_loss_any_step=w_loss, at=at_loss, worst_grad_leaf=w_grad,
        at_grad=at_grad, worst_update_leaf=w_upd, at_update=at_upd,
        program_losses=program_losses, reference_losses=ref_losses)
    # the leaves' gap quartiles beside the medians, for a later choice of number
    q = lambda d, f: sorted(d.values())[min(len(d) - 1, int(f * len(d)))]
    r.notes["diag"] = dict(
        loss1=step1,
        grad_q={n: [q(g, f) for f in (0.5, 0.75, 0.9)] for n, g in grads.items()},
        upd_q={n: [q(u, f) for f in (0.5, 0.75, 0.9)] for n, u in updates.items()})
    numbers = {"loss_gap": compare.worst(step1)[0], "grad_gap": grad_median,
               "update_gap": update_median}
    limits = r.cell.workload["limits"]
    r.notes["not compared"] = {k: v for k, v in numbers.items() if k not in limits}
    r.checks = [Check(k, v, limits[k]) for k, v in numbers.items() if k in limits]


def _first_grads(state, cfg):
    """The gradient each optimiser got in the first step, from its first
    moment: mu = (1 - b1) g."""
    out = {}
    for net, module, opt, b1 in (("G", state.G, state.opt_G, cfg["G_B1"]),
                                 ("D", state.D, state.opt_D, cfg["D_B1"])):
        out[net] = {n: (opt.state[p]["mu"] / (1.0 - b1)).detach().clone()
                    for n, p in module.named_parameters()}
    return out


def _trainer_grads(trainer, net):
    """The reference trainer's first gradients, from its Adam's mu."""
    opt = trainer.opt_G if net == "G" else trainer.opt_D
    return {k: (v / (1.0 - opt.b1)).clone() for k, v in opt.mu.items()}
