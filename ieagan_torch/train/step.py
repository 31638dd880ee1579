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

Random draws come from the caller's ``torch.Generator`` or, for tests and
golden checks, from ``draw_schedule``, consumed in call order: per D
accumulation z, rdof (with RRM_prx_G), the fakes' DiffAugment draws and the
reals' (with diff_aug / diff_aug_real); then per G accumulation z, rdof and
the fakes' draws.

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
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Iterable

import numpy as np
import torch

from ieagan_torch import losses
from ieagan_torch.core.config import DEFAULT_CONFIG
from ieagan_torch.models.discriminator import Discriminator
from ieagan_torch.models.generator import Generator
from ieagan_torch.ops.diff_aug import diff_augment, sample_diff_aug_draws
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


def _unported(config: dict) -> list[str]:
    checks = {
        "conditional_strategy": config["conditional_strategy"] != "Contra",
        "Con_reg": bool(config["Con_reg"]),
        "split_D": not bool(config["split_D"]),
        "replicate_G_step_bug": bool(config.get("replicate_G_step_bug", False)),
    }
    return [k for k, v in checks.items() if v]


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
                    *, draw_schedule: Iterable | None = None, capture_grads: bool = False):
    """The step ``train_step(state, x, y, generator) -> metrics`` for a state
    that holds ``G`` and ``D``, in the state's compute type.

    x: (B, H, W, 1) real images in [-1, 1]; y: (B,) int labels; B a multiple
    of the event size. ``metrics`` maps D_loss_real, D_loss_fake,
    unif_loss_d, iea_loss, unif_loss_g and G_loss to floats (those the config
    turns on). ``draw_schedule`` replaces the random draws, in call order
    (see the module docstring); ``capture_grads`` adds the gradients after
    ortho-reg, by parameter name, under ``_grads_D`` and ``_grads_G``.
    ``steps_per_epoch`` sets the learning-rate schedule's epochs (constant
    while 0, as the JAX package's step).
    """
    config = dict(DEFAULT_CONFIG, **config)
    bad = _unported(config)
    if bad:
        raise NotImplementedError(f"train-step options not ported: {bad}")
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

    def draw(kind, generator, x):
        """A draw for the batch ``x``: the images' own dtype sets the
        granularity of their DiffAugment draws."""
        b, h, w, _ = x.shape
        if schedule is not None:
            return _on(x.device, next(schedule), torch.float32 if kind != "aug" else None)
        if kind == "z":
            return torch.randn((b, dim_z), generator=generator, device=x.device) * z_std
        if kind == "rdof":
            return torch.randn((b, rdof_dim), generator=generator, device=x.device)
        return sample_diff_aug_draws(generator, b, h, w, policy, device=x.device, dtype=x.dtype)

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
        """Ortho-reg on the gradients; a parameter the loss did not reach gets
        a zero gradient, since optax updates every leaf."""
        apply_ortho_reg(module, strength, blacklist)
        for p in module.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)

    def train_step(state: TrainState, x, y, generator: torch.Generator | None = None) -> dict:
        if state.G is not G or state.D is not D:
            raise ValueError("this train step was made for other G and D modules")
        compute_dtype = state.compute_dtype
        metrics = {}
        mask = losses.make_mask(y, n_classes)
        G.train()
        D.train()

        # ---------------- D phase ----------------
        G.requires_grad_(False)
        D.requires_grad_(True)
        embed_real = None
        for _ in range(num_D_steps):
            state.opt_D.zero_grad(set_to_none=True)
            for _ in range(num_D_acc):
                z, rdof = draw_latents(generator, x, compute_dtype)
                with torch.no_grad():
                    fake = G(z, y, rdof)
                fake_in, x_in = fake, x
                if do_diff_aug:
                    fake_in = diff_augment(fake, draw("aug", generator, fake), policy)
                    if diff_aug_real:
                        x_in = diff_augment(x, draw("aug", generator, x), policy)
                _, _, score_f = D(fake_in, y)
                proxy_r, embed_r, score_r = D(x_in.to(compute_dtype), y)
                loss_real, loss_fake = losses.loss_hinge_dis(score_f, score_r)
                d_loss = loss_real + loss_fake + contra_lambda * contra(embed_r, proxy_r, mask, y)
                mets = {"D_loss_real": loss_real, "D_loss_fake": loss_fake}
                if unif_on:
                    u = losses.unif_loss(embed_r)
                    d_loss = d_loss + unif_lambda * u
                    mets["unif_loss_d"] = u
                (d_loss / float(num_D_acc)).backward()
                embed_real = embed_r.detach()
            finish_grads(D, d_ortho)
            if capture_grads:
                metrics["_grads_D"] = capture(D)
            state.opt_D.step(d_lr)
            metrics.update(mets)

        # ---------------- G phase ----------------
        D.requires_grad_(False)
        G.requires_grad_(True)
        state.opt_G.zero_grad(set_to_none=True)
        for _ in range(num_G_acc):
            z, rdof = draw_latents(generator, x, compute_dtype)
            fake = G(z, y, rdof)
            if do_diff_aug:
                fake = diff_augment(fake, draw("aug", generator, fake), policy)
            proxy_f, embed_f, score_f = D(fake, y)
            g_loss = losses.loss_hinge_gen(score_f) + contra_lambda * contra(
                embed_f, proxy_f, mask, y)
            mets = {}
            if iea_on:
                il = losses.iea_loss(embed_f, embed_real)
                g_loss = g_loss + iea_lambda * il
                mets["iea_loss"] = il
                if unif_on:  # nested under IEA_loss (reference: train_fns.py:176-178)
                    ug = losses.unif_loss(embed_f)
                    g_loss = g_loss + unif_lambda * ug
                    mets["unif_loss_g"] = ug
            g_loss = g_loss / float(num_G_acc)
            mets["G_loss"] = g_loss
            g_loss.backward()
        finish_grads(G, g_ortho, G_ORTHO_BLACKLIST)
        if capture_grads:
            metrics["_grads_G"] = capture(G)
        state.opt_G.step(g_lr)
        metrics.update(mets)

        # ---------------- EMA ----------------
        state.itr += 1
        if ema_on:
            update_ema(state.G_ema, G, 0.0 if state.itr < ema_start else ema_decay)
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
