"""The GAN train step: D phase, G phase, EMA (twin of
``ieagan_tpu/train/step.py:45-376``; reference: train_fns.py:20-206).

The JAX package threads parameters, optimizer moments, batch-norm stats and
spectral-norm vectors through one functional step. Here they live in the
modules and optimizers of a ``TrainState`` and are updated in place, with the
same detach points and the same order of updates:

  * D phase: G runs in train mode under ``no_grad`` (its BN running stats and
    SN ``u`` still advance); DiffAugment on the fakes and, with
    ``diff_aug_real``, on the reals with a second set of draws; under
    ``split_D`` the fake pass runs first, then the real pass, each advancing
    D's ``u``. Loss: hinge + contra_lambda * 2C(embed_r, proxy_r) +
    unif_lambda * uniformity(embed_r). Ortho-reg is added to the gradient
    after backward, then Adam steps.
  * G phase: fresh z, gradients flow through the already updated D into G;
    D's parameters take no gradient (toggle_grads) but D runs in train mode,
    so its ``u`` advances a third time. Loss: hinge + contra_lambda *
    2C(embed_f, proxy_f) + IEA_lambda * IEA(embed_f, embed_r of the D phase,
    detached) + unif_lambda * uniformity(embed_f), the last nested under
    IEA_loss as in the reference.
  * EMA over every float tensor of G's state (parameters, BN stats, ``u``,
    ``sv``, the standing counter) with decay 0 until ``ema_start``.

Traced (``core/spans.py``), the step is the span ``ieagan.train.step``,
holding ``ieagan.train.d_phase`` and ``ieagan.train.g_phase`` (each with its
``d_forward``/``d_backward`` or ``g_forward``/``g_backward`` and one
``ieagan.train.update``: zero-fill, all-reduce, ortho-reg, Adam), then
``ieagan.train.ema`` and ``ieagan.train.wait``, the host blocked on the card
while the metrics are read.

Options, as the JAX package's step takes them:

  * ``split_D=False``: one D pass over ``[fake; real]`` with labels
    ``[y; y]`` in the D phase (the G phase still passes the fakes alone);
  * ``Con_reg``: a third D pass in the D phase, over ``cr_diff_augment`` of
    the reals, adding cr_lambda * (l2(score_r, score_ra) + l2(embed_r,
    embed_ra)) under Contra, the score term alone under Proj;
  * ``conditional_strategy="Proj"``: D returns its score alone and only the
    hinge losses (and Con_reg's score term) apply;
  * ``replicate_G_step_bug``: G's Adam skips its update while ``clip_norm``
    is None (the reference's gating, train_fns.py:190-192).

Random draws come from the caller's ``torch.Generator`` or, for tests and
golden checks, from ``draw_schedule``, consumed in call order: per D
accumulation z, rdof (with RRM_prx_G), the fakes' DiffAugment draws and the
reals' (with diff_aug / diff_aug_real), the reals' consistency draws (with
Con_reg; ``sample_cr_draws``); then per G accumulation z, rdof and the fakes'
draws.

The step computes in the state's compute type (``core/precision.py``), as
the JAX package's modules built with the policy's dtype do: z is drawn in f32
and cast (``ieagan_tpu/train/step.py:194``, ``generator.py:201``), rdof is
cast by G, the reals are augmented in f32 with f32 draws and cast at D's
input, the fakes are augmented in the compute type with draws of its
granularity; batch-norm moments, softmax statistics and losses stay f32, and
parameters, their gradients, Adam and the EMA are f32. The learning-rate
schedule belongs to the step, as the JAX package's scheduled optimizer does,
and is handed to each optimizer step; the state's optimizers keep the moments
and counts.

Data parallel (``mesh``, ``core/mesh.py``; ``parallel/sharding.py`` builds
it): N ranks of b images each compute what the step computes on the global
batch of N·b, as the JAX package's step does under its sharded jit:

  * every draw is made at the global batch's shape from a generator in the
    same state on every rank (or taken from ``draw_schedule`` at that
    shape), and each rank keeps its rows ``[r·b, (r+1)·b)``;
  * batch norm takes the global batch's moments (``ops/norm.py``), the
    prior embedding its norm (``ops/prior.py``), and under
    ``rrm_full_batch_sequence`` D's RRMs run over the global batch as
    one sequence, gathered in rank order, each rank keeping its rows
    (``models/discriminator.py``); in concat mode a rank's pass is
    ``[fake_r; real_r]``, so the sequence is ``[f_0; r_0; f_1; r_1]`` where
    the JAX global batch is ``[F; R]``: the RRM has no positional term, so
    only its sums run in another order;
  * the labels, D's embeddings and proxies are gathered in rank order before
    ``make_mask``, 2C, uniformity and IEA, which every rank computes on the
    whole batch; the gather's backward sums their gradient over the ranks;
  * the mean-reduced losses (hinge, the consistency l2) stay per rank;
  * each network's gradients are averaged over the ranks after the
    zero-fill and before ortho-reg and Adam, so every rank takes the same
    update from the gradient of the global loss, the mean of the ranks'
    losses (hinge terms: the mean of the ranks' means; gathered terms: every
    rank's copy of the one value);
  * the metrics are the ranks' means, the global batch's values.

Tensor parallel (a mesh with a ``model`` axis, ``parallel/sharding.py``
places the state): the ranks of one data index hold the same rows, the same
draws and each its shard of every leaf the JAX rule splits, and compute what
one process computes (the split layers, ``parallel/tensor.py``):

  * the data axis's reductions above run over the ranks of one model index
    (``core/mesh.py::Mesh.data_group``);
  * a shard's gradient is averaged over the data axis only; a replicated
    parameter's over the data axis and then over the model axis, which
    keeps its replicas equal (cuDNN's weight gradients need not agree bit
    for bit);
  * ortho-reg and ``clip_norm``'s global norm span the model axis
    (``train/ortho.py``, ``train/optim.py``); the EMA is local.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Iterable

import numpy as np
import torch

from ieagan_torch import losses
from ieagan_torch.core.config import DEFAULT_CONFIG
from ieagan_torch.core.spans import span
from ieagan_torch.models.discriminator import Discriminator
from ieagan_torch.models.generator import Generator
from ieagan_torch.ops.diff_aug import (cr_diff_augment, diff_augment, sample_cr_draws,
                                       sample_diff_aug_draws)
from ieagan_torch.parallel.collectives import (all_gather_rows, all_reduce_grads,
                                               all_reduce_sum, global_batch, model_parallel)
from ieagan_torch.parallel.tensor import split_parameters
from ieagan_torch.train.optim import lr_schedules, make_optimizers
from ieagan_torch.train.ortho import apply_ortho_reg
from ieagan_torch.utils.checkpoint import load_checkpoint

# G's shared class embedding takes no ortho-reg (reference: train_fns.py:187-188)
G_ORTHO_BLACKLIST = ("shared.",)


@dataclasses.dataclass
class TrainState:
    """Everything a step reads and updates. ``G_ema`` stays in eval mode and
    takes no gradient; ``itr`` counts finished steps; ``compute_dtype`` is
    the policy's compute type the step runs in."""
    G: Generator
    D: Discriminator
    G_ema: Generator
    opt_G: torch.optim.Optimizer
    opt_D: torch.optim.Optimizer
    itr: int = 0
    compute_dtype: torch.dtype = torch.float32


def _assemble(G, D, config, compute_dtype: torch.dtype) -> TrainState:
    G_ema = copy.deepcopy(G)  # EMA starts as a copy (reference: utils/__init__.py:817-821)
    G_ema.eval().requires_grad_(False)
    G.train()
    D.train()
    opt_G, opt_D = make_optimizers(G, D, config)
    return TrainState(G=G, D=D, G_ema=G_ema, opt_G=opt_G, opt_D=opt_D,
                      compute_dtype=compute_dtype)


def init_train_state(G: Generator, D: Discriminator, config: dict,
                     generator: torch.Generator | None = None,
                     compute_dtype: torch.dtype = torch.float32) -> TrainState:
    """Random init of ``G`` and ``D`` from ``generator`` (on their device),
    ``G_ema`` a copy of ``G``, fresh Adam moments, ``itr`` 0; the steps
    compute in ``compute_dtype``."""
    G.reset_parameters(generator)
    D.reset_parameters(generator)
    return _assemble(G, D, dict(DEFAULT_CONFIG, **config), compute_dtype)


def restore_train_state(path: str, tag: str, config: dict | None = None,
                        device="cuda", compute_dtype: torch.dtype = torch.float32) -> TrainState:
    """A ``TrainState`` on ``device`` from the G, D and G_ema weights and the
    ``itr`` of checkpoint ``tag`` under ``path`` (either package's), with
    fresh Adam moments; the steps compute in ``compute_dtype``. ``config``
    overrides ``DEFAULT_CONFIG``. Every key of every checkpoint must fit the
    port's modules. ``utils/checkpoint.py::load_checkpoint`` restores a whole
    run, optimizer files included, into a state."""
    config = dict(DEFAULT_CONFIG, **(config or {}))
    with torch.device(device):
        G, D = Generator.from_config(config), Discriminator.from_config(config)
    state = _assemble(G, D, config, compute_dtype)
    return load_checkpoint(path, state, tag, load_optim=False)[0]


def _on(device, item, dtype=None):
    """A scheduled draw (array, tensor or dict of them) as tensors on device;
    numpy bfloat16 arrays (JAX's bfloat16 draws) arrive unchanged."""
    if isinstance(item, dict):
        return {k: _on(device, v) for k, v in item.items()}
    if isinstance(item, torch.Tensor):
        return item.to(device=device, dtype=dtype)
    if isinstance(item, np.ndarray) and item.dtype.name == "bfloat16":
        return torch.from_numpy(item.astype(np.float32)).to(
            device=device, dtype=dtype or torch.bfloat16)
    return torch.tensor(item, dtype=dtype, device=device)


def make_train_step(G: Generator, D: Discriminator, config: dict, steps_per_epoch: int = 0,
                    *, draw_schedule: Iterable | None = None, capture_grads: bool = False,
                    mesh=None):
    """The step ``train_step(state, x, y, generator) -> metrics`` for a state
    that holds ``G`` and ``D``, in the state's compute type.

    x: (B, H, W, 1) real images in [-1, 1]; y: (B,) int labels; B a multiple
    of the event size. ``metrics`` maps D_loss_real, D_loss_fake,
    unif_loss_d, iea_loss, unif_loss_g and G_loss to floats (those the config
    turns on; unif_loss_d, iea_loss and unif_loss_g only under Contra).
    ``draw_schedule`` replaces the random draws, in call order (see the
    module docstring); ``capture_grads`` adds the gradients after
    ortho-reg, by parameter name, under ``_grads_D`` and ``_grads_G``.
    ``steps_per_epoch`` sets the learning-rate schedule's epochs (constant
    while 0, as the JAX package's step). With a ``mesh`` of N ranks, x and y
    are this rank's rows of the global batch, every draw (scheduled ones too)
    is at the global batch's shape, and the metrics and updates are the
    global batch's (module docstring).
    """
    config = dict(DEFAULT_CONFIG, **config)
    strategy = config["conditional_strategy"]
    if strategy not in ("Contra", "Proj"):
        raise NotImplementedError(f"conditional_strategy {strategy!r}")
    contra_on = strategy == "Contra"
    split_D = bool(config["split_D"])
    con_reg, cr_lambda = bool(config["Con_reg"]), float(config["cr_lambda"])
    # G's optimizer skips its update while clip_norm is None (the reference's
    # bug, train_fns.py:190-192, reproduced on request)
    skip_g_update = (bool(config.get("replicate_G_step_bug", False))
                     and config.get("clip_norm") is None)
    n_classes = int(config["n_classes"])
    dim_z, rdof_dim = int(config["dim_z"]), int(config["rdof_dim"])
    use_rdof = bool(config["RRM_prx_G"])
    z_std = float(config.get("z_var", 1.0)) ** 0.5
    do_diff_aug = bool(config["diff_aug"])
    diff_aug_real = bool(config.get("diff_aug_real", True))
    policy = str(config.get("diff_aug_policy", "color,translation,cutout"))
    contra_lambda = float(config["contra_lambda"])
    unif_on, unif_lambda = bool(config["Uniformity_loss"]), float(config["unif_lambda"])
    iea_on, iea_lambda = bool(config["IEA_loss"]), float(config["IEA_lambda"])
    temperature = float(config.get("temperature", 1.0))
    pos_collected = bool(config["pos_collected_numerator"])
    num_D_steps = int(config["num_D_steps"])
    num_D_acc, num_G_acc = int(config["num_D_accumulations"]), int(config["num_G_accumulations"])
    g_ortho, d_ortho = float(config["G_ortho"]), float(config["D_ortho"])
    ema_on, ema_decay = bool(config["ema"]), float(config["ema_decay"])
    ema_start = int(config["ema_start"])
    g_lr, d_lr = lr_schedules(config, steps_per_epoch)
    schedule = iter(draw_schedule) if draw_schedule is not None else None
    n_ranks = 1 if mesh is None else mesh.n_data
    gather = lambda t: all_gather_rows(t, mesh)

    def draw(kind, generator, x):
        """A draw for the batch ``x``: the images' own dtype sets the
        granularity of their DiffAugment draws. Drawn at the global batch's
        shape; this rank's rows."""
        n, h, w, _ = x.shape
        if schedule is not None:
            out = _on(x.device, next(schedule), torch.float32 if kind in ("z", "rdof") else None)
        elif kind == "z":
            out = torch.randn((n * n_ranks, dim_z), generator=generator, device=x.device) * z_std
        elif kind == "rdof":
            out = torch.randn((n * n_ranks, rdof_dim), generator=generator, device=x.device)
        elif kind == "cr":
            out = sample_cr_draws(generator, n * n_ranks, h, w, device=x.device)
        else:
            out = sample_diff_aug_draws(generator, n * n_ranks, h, w, policy, device=x.device,
                                        dtype=x.dtype)
        if n_ranks == 1:
            return out
        rows = mesh.rows(n)
        return {k: v[rows] for k, v in out.items()} if isinstance(out, dict) else out[rows]

    def d_forward(x, y):
        """D's ``(proxy, embed, score (B,))``; Proj gives the score alone."""
        if contra_on:
            return D(x, y)
        return None, None, D(x, y).squeeze(-1)

    def draw_latents(generator, x, compute_dtype):
        """z drawn in f32 and cast to the compute type; rdof in f32 (G casts)."""
        z = draw("z", generator, x).to(compute_dtype)
        return z, (draw("rdof", generator, x) if use_rdof else None)

    def contra(embed, proxy, mask, y):
        return losses.conditional_contrastive_loss(embed, proxy, mask, y, temperature,
                                                   0.0, pos_collected)

    def capture(module):
        return {n: p.grad.detach().clone() for n, p in module.named_parameters()}

    def finish_grads(module, strength, blacklist=()):
        """A parameter the loss did not reach gets a zero gradient, since
        optax updates every leaf; the gradients are averaged over the ranks,
        then ortho-reg is added (to a zero gradient it is the term alone).
        Returns the optimizer's ``model_split`` (None without a model axis)."""
        for p in module.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        split = split_parameters(module)
        all_reduce_grads(module, mesh, split)
        apply_ortho_reg(module, strength, blacklist)
        return (mesh, split) if model_parallel(mesh) else None

    def d_pass(x, y, y_all, mask, generator, compute_dtype):
        """One accumulation's forward work of the D phase: G's no-grad
        forward, DiffAugment, D's passes and the losses. Returns ``(d_loss,
        mets, embed_r_all)``, the last None without Contra."""
        z, rdof = draw_latents(generator, x, compute_dtype)
        with torch.no_grad():
            fake = G(z, y, rdof)
        fake_in, x_in = fake, x
        if do_diff_aug:
            fake_in = diff_augment(fake, draw("aug", generator, fake), policy)
            if diff_aug_real:
                x_in = diff_augment(x, draw("aug", generator, x), policy)
        x_in = x_in.to(compute_dtype)
        if split_D:  # the fake pass, then the real pass (reference: model.py:985-1010)
            _, _, score_f = d_forward(fake_in, y)
            proxy_r, embed_r, score_r = d_forward(x_in, y)
        else:  # one pass over [fake; real] (reference: model.py:1023-1086)
            proxy, embed, score = d_forward(torch.cat([fake_in, x_in]), torch.cat([y, y]))
            nb = fake_in.shape[0]
            score_f, score_r = score[:nb], score[nb:]
            proxy_r = None if proxy is None else proxy[nb:]
            embed_r = None if embed is None else embed[nb:]
        loss_real, loss_fake = losses.loss_hinge_dis(score_f, score_r)
        d_loss = loss_real + loss_fake
        mets = {"D_loss_real": loss_real, "D_loss_fake": loss_fake}
        embed_r_all = None
        if contra_on:
            embed_r_all = gather(embed_r)
            d_loss = d_loss + contra_lambda * contra(embed_r_all, gather(proxy_r), mask, y_all)
        if con_reg:  # a third D pass (reference: train_fns.py:57-66)
            x_aug = cr_diff_augment(x, draw("cr", generator, x)).to(compute_dtype)
            _, embed_ra, score_ra = d_forward(x_aug, y)
            consistency = losses.l2_loss(score_r, score_ra)
            if contra_on:
                consistency = consistency + losses.l2_loss(embed_r, embed_ra)
            d_loss = d_loss + cr_lambda * consistency
        if contra_on and unif_on:
            u = losses.unif_loss(embed_r_all)
            d_loss = d_loss + unif_lambda * u
            mets["unif_loss_d"] = u
        return d_loss, mets, embed_r_all

    def g_pass(x, y, y_all, mask, embed_real, generator, compute_dtype):
        """One accumulation's forward work of the G phase: G's forward,
        DiffAugment, D's pass and the losses. Returns ``(g_loss, mets)``,
        the loss divided over the accumulations."""
        z, rdof = draw_latents(generator, x, compute_dtype)
        fake = G(z, y, rdof)
        if do_diff_aug:
            fake = diff_augment(fake, draw("aug", generator, fake), policy)
        proxy_f, embed_f, score_f = d_forward(fake, y)
        g_loss = losses.loss_hinge_gen(score_f)
        mets = {}
        if contra_on:
            embed_f = gather(embed_f)
            g_loss = g_loss + contra_lambda * contra(embed_f, gather(proxy_f), mask, y_all)
        if contra_on and iea_on:
            il = losses.iea_loss(embed_f, embed_real)
            g_loss = g_loss + iea_lambda * il
            mets["iea_loss"] = il
            if unif_on:  # nested under IEA_loss (reference: train_fns.py:176-178)
                ug = losses.unif_loss(embed_f)
                g_loss = g_loss + unif_lambda * ug
                mets["unif_loss_g"] = ug
        g_loss = g_loss / float(num_G_acc)
        mets["G_loss"] = g_loss
        return g_loss, mets

    def global_means(mets):
        """The ranks' mean of each metric (one all-reduce)."""
        if n_ranks == 1 or not mets:
            return mets
        names = list(mets)
        vals = all_reduce_sum(torch.stack([mets[k].detach().float() for k in names]), mesh)
        return dict(zip(names, vals / n_ranks))

    def train_step(state: TrainState, x, y, generator: torch.Generator | None = None) -> dict:
        if state.G is not G or state.D is not D:
            raise ValueError("this train step was made for other G and D modules")
        with span("ieagan.train.step"), global_batch(mesh):
            return step_body(state, x, y, generator)

    def step_body(state, x, y, generator):
        compute_dtype = state.compute_dtype
        metrics = {}
        y_all = gather(y)
        mask = losses.make_mask(y_all, n_classes)
        G.train()
        D.train()

        # ---------------- D phase ----------------
        with span("ieagan.train.d_phase"):
            G.requires_grad_(False)
            D.requires_grad_(True)
            embed_real = None
            for _ in range(num_D_steps):
                state.opt_D.zero_grad(set_to_none=True)
                for _ in range(num_D_acc):
                    with span("ieagan.train.d_forward"):
                        d_loss, mets, embed_r_all = d_pass(x, y, y_all, mask, generator,
                                                           compute_dtype)
                    with span("ieagan.train.d_backward"):
                        (d_loss / float(num_D_acc)).backward()
                    embed_real = embed_r_all.detach() if contra_on else None
                with span("ieagan.train.update"):
                    split = finish_grads(D, d_ortho)
                    if capture_grads:
                        metrics["_grads_D"] = capture(D)
                    state.opt_D.step(d_lr, split)
                metrics.update(global_means(mets))

        # ---------------- G phase ----------------
        with span("ieagan.train.g_phase"):
            D.requires_grad_(False)
            G.requires_grad_(True)
            state.opt_G.zero_grad(set_to_none=True)
            for _ in range(num_G_acc):
                with span("ieagan.train.g_forward"):
                    g_loss, mets = g_pass(x, y, y_all, mask, embed_real, generator,
                                          compute_dtype)
                with span("ieagan.train.g_backward"):
                    g_loss.backward()
            with span("ieagan.train.update"):
                split = finish_grads(G, g_ortho, G_ORTHO_BLACKLIST)
                if capture_grads:
                    metrics["_grads_G"] = capture(G)
                if not skip_g_update:
                    state.opt_G.step(g_lr, split)
            metrics.update(global_means(mets))

        # ---------------- EMA ----------------
        state.itr += 1
        if ema_on:
            with span("ieagan.train.ema"):
                update_ema(state.G_ema, G, 0.0 if state.itr < ema_start else ema_decay)
        with span("ieagan.train.wait"):
            return {k: v if k.startswith("_") else float(v.detach()) for k, v in metrics.items()}

    return train_step


@torch.no_grad()
def update_ema(ema: torch.nn.Module, source: torch.nn.Module, decay: float):
    """``e = e * decay + p * (1 - decay)`` in f32 for every float tensor of
    the state dicts (parameters and buffers); other tensors are copied."""
    src = source.state_dict()
    d = None
    for name, e in ema.state_dict().items():
        p = src[name]
        if not e.is_floating_point():
            e.copy_(p)
            continue
        if d is None:
            d = torch.tensor(decay, dtype=torch.float32, device=e.device)
        e.mul_(d).add_(p * (1.0 - d))
