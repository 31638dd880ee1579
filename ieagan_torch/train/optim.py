"""Optimizers and LR schedules of the train step (twin of
``ieagan_tpu/train/optim.py``).

Adam with betas (B1, B2) = (0, 0.999), eps 1e-6 and no weight decay
(reference: model.py:410-416, 858-864); AMSGrad and AdaBelief (reference
flags: config.json:116,119); the LR schedules 'default' (constant),
'CosAnnealLR' (epoch-stepped cosine to lr/4, reference: model.py:420-422) and
'CosAnnealWarmRes' (warm restarts T_0=10, T_mult=2, model.py:423-425);
clipping by the global gradient norm, which sees the gradients after
ortho-reg (reference step order, train_fns.py:185-192).

``OptaxAdam`` computes what the JAX package's optax chain computes and keeps
the same state, so a checkpoint carries over in both directions
(``models/convert.py::optimizer_state_to_flax``): per parameter ``mu``,
``nu`` (and ``nu_max`` under AMSGrad), the moments' ``count`` and the
schedule's ``sched_count``. The two counts differ only after a legacy
checkpoint is grafted (``utils/checkpoint.py``). The optimizer holds no
learning rate: each ``step(lr)`` is given one, a float or a schedule of
``sched_count``, by the train step that owns the schedule (as the JAX
package's step builds its scheduled chain). torch's own optimizers are
no twin: ``Adam(amsgrad=True)`` takes the maximum of the raw second moment
where optax takes it of the bias-corrected one, torch has no AdaBelief, and
``clip_grad_norm_`` scales by ``max / (norm + 1e-6)`` where optax scales by
``max / norm``, and only above the threshold.
"""

from __future__ import annotations

import copy
import math
from typing import Callable

import numpy as np
import torch

from ieagan_torch.parallel.collectives import model_reduce

_F32 = np.float32
ADABELIEF_EPS_ROOT = 1e-16  # optax.adabelief's default


def make_lr_schedule(base_lr: float, sched_version: str | None, num_epochs: int,
                     steps_per_epoch: int):
    """The learning rate as a function of the schedule's count (updates
    made), or the constant ``base_lr``; stepped per epoch as the reference's
    scheduler is (reference: train.py:244-247). Evaluated in float32 as the
    JAX package's schedule is."""
    if sched_version in ("default", None) or steps_per_epoch <= 0:
        return base_lr
    eta_min = base_lr / 4.0
    half_range = _F32(0.5 * (base_lr - eta_min))

    def cosine(t):
        return float(_F32(eta_min) + half_range * (_F32(1.0) + np.cos(_F32(math.pi) * t)))

    if sched_version == "CosAnnealLR":
        def sched(count: int) -> float:
            epoch = count // steps_per_epoch
            return cosine(_F32(min(epoch, num_epochs)) / _F32(max(num_epochs, 1)))
        return sched

    if sched_version == "CosAnnealWarmRes":
        def sched(count: int) -> float:
            epoch = _F32(count // steps_per_epoch)
            # T_0=10, T_mult=2: restart boundaries at 10*(2^k - 1)
            k = np.floor(np.log2(epoch / _F32(10.0) + _F32(1.0)))
            t_start = _F32(10.0) * (_F32(2.0) ** k - _F32(1.0))
            t_i = _F32(10.0) * _F32(2.0) ** k
            return cosine((epoch - t_start) / t_i)
        return sched

    return base_lr


def _group_entry(name: str) -> property:
    """An attribute that reads and writes ``name`` of the optimizer's one
    parameter group."""
    return property(lambda self: self.param_groups[0][name],
                    lambda self, value: self.param_groups[0].__setitem__(name, value))


class OptaxAdam(torch.optim.Optimizer):
    """Adam, AMSGrad or AdaBelief as optax computes them, behind an optional
    ``clip_by_global_norm``. The moments are allocated at construction, as
    optax's ``init`` does, and every parameter takes an update each step (a
    missing gradient counts as zero).

    ``clip_norm``, ``variant`` and the two counts live in the one parameter
    group, which ``torch.optim.Optimizer`` carries through ``state_dict``,
    ``load_state_dict``, ``copy.deepcopy`` and pickling, as optax's state
    pytree carries its counts; an attribute of the optimizer would be lost
    by each of them."""

    def __init__(self, params, b1: float, b2: float, eps: float,
                 clip_norm: float | None = None, amsgrad: bool = False,
                 ada_belief: bool = False):
        variant = "adabelief" if ada_belief else ("amsgrad" if amsgrad else "adam")
        super().__init__(params, dict(
            b1=b1, b2=b2, eps=eps, clip_norm=None if clip_norm is None else float(clip_norm),
            variant=variant,
            count=0,         # ScaleByAdamState.count (and its AMSGrad/AdaBelief twins)
            sched_count=0))  # ScaleByScheduleState.count
        if len(self.param_groups) != 1:
            raise ValueError("OptaxAdam takes one parameter group")
        for p in self.params:
            state = self.state[p]
            for name in self.moment_names:
                state[name] = torch.zeros_like(p, memory_format=torch.contiguous_format)

    clip_norm = _group_entry("clip_norm")
    variant = _group_entry("variant")
    count = _group_entry("count")
    sched_count = _group_entry("sched_count")

    def load_state_dict(self, state_dict: dict):
        """``torch.optim.Optimizer.load_state_dict`` on a copy of
        ``state_dict``, refusing the state of another variant (its moments
        are not this optimizer's). torch's own load keeps the dict's tensors
        where their type and device fit, and the moments are updated in
        place: without the copy, the optimizer the dict came from and this
        one would step the same moments."""
        groups = state_dict.get("param_groups", [])
        theirs = groups[0].get("variant") if len(groups) == 1 else None
        if theirs != self.variant:
            raise ValueError(f"the state dict is of {theirs!r}, this optimizer {self.variant!r}")
        super().load_state_dict(copy.deepcopy(state_dict))

    @property
    def params(self) -> list:
        return self.param_groups[0]["params"]

    @property
    def moment_names(self) -> tuple:
        return ("mu", "nu", "nu_max") if self.variant == "amsgrad" else ("mu", "nu")

    @torch.no_grad()
    def step(self, lr: float | Callable[[int], float], model_split=None):
        """One update at ``lr``: a float, or a function of ``sched_count``
        (``make_lr_schedule``). ``model_split = (mesh, ids)`` names the
        parameters that hold a shard over the mesh's model axis (their
        ``id``s): the global norm that ``clip_norm`` reads sums their squares
        over the axis and counts each replicated parameter once."""
        group = self.param_groups[0]
        b1, b2, eps = group["b1"], group["b2"], group["eps"]
        params = self.params
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        if self.clip_norm is not None:
            # optax.clip_by_global_norm: unchanged below the threshold, else t / norm * max
            squares = torch.stack([torch.sum(g * g) for g in grads])
            if model_split is None:
                total = squares.sum()
            else:
                mesh, ids = model_split
                split = torch.tensor([id(p) in ids for p in params], device=squares.device)
                total = (squares[~split].sum()
                         + model_reduce(squares[split].sum().reshape(1), mesh)[0])
            norm = torch.sqrt(total)
            keep = norm < self.clip_norm
            grads = [torch.where(keep, g, g / norm * self.clip_norm) for g in grads]
        mus = [self.state[p]["mu"] for p in params]
        nus = [self.state[p]["nu"] for p in params]
        # update_moment: (1 - b) * g**order + b * moment, each product rounded
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, torch._foreach_mul(grads, 1.0 - b1))
        second = grads if self.variant != "adabelief" else torch._foreach_sub(grads, mus)
        torch._foreach_mul_(nus, b2)
        torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(second, second), 1.0 - b2))
        if self.variant == "adabelief":
            torch._foreach_add_(nus, ADABELIEF_EPS_ROOT)
        self.count += 1
        bc1 = float(_F32(1.0) - _F32(b1) ** _F32(self.count))
        bc2 = float(_F32(1.0) - _F32(b2) ** _F32(self.count))
        mu_hat = torch._foreach_div(mus, bc1)
        nu_hat = torch._foreach_div(nus, bc2)
        if self.variant == "amsgrad":
            nu_max = [self.state[p]["nu_max"] for p in params]
            torch._foreach_maximum_(nu_max, nu_hat)
            nu_hat = nu_max
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, eps)
        updates = torch._foreach_div(mu_hat, denom)
        lr = lr(self.sched_count) if callable(lr) else lr
        step_size = float(_F32(-lr))
        self.sched_count += 1
        torch._foreach_add_(params, torch._foreach_mul(updates, step_size))


def make_optimizer(params, b1: float, b2: float, eps: float,
                   clip_norm: float | None = None, amsgrad: bool = False,
                   ada_belief: bool = False) -> OptaxAdam:
    """The optimizer over ``params``; its learning rate comes with each step."""
    return OptaxAdam(params, b1, b2, eps, clip_norm=clip_norm, amsgrad=amsgrad,
                     ada_belief=ada_belief)


def lr_schedules(config: dict, steps_per_epoch: int):
    """``(G_lr, D_lr)``: the config's learning rates under its
    ``sched_version`` for ``steps_per_epoch``; constant while that is 0."""
    return tuple(make_lr_schedule(float(config[f"{net}_lr"]),
                                  config.get("sched_version", "default"),
                                  int(config.get("num_epochs", 1)), steps_per_epoch)
                 for net in ("G", "D"))


def make_optimizers(G, D, config: dict):
    """``(opt_G, opt_D)`` for the generator and discriminator from the
    config's G_B1/G_B2/D_B1/D_B2, adam_eps, clip_norm, amsgrad and
    ada_belief; the learning rates are the train step's (``lr_schedules``)."""
    common = dict(eps=float(config["adam_eps"]), clip_norm=config.get("clip_norm"),
                  amsgrad=bool(config.get("amsgrad", False)),
                  ada_belief=bool(config.get("ada_belief", False)))
    opt_G = make_optimizer(G.parameters(), float(config["G_B1"]), float(config["G_B2"]),
                           **common)
    opt_D = make_optimizer(D.parameters(), float(config["D_B1"]), float(config["D_B2"]),
                           **common)
    return opt_G, opt_D
