"""Optimizers of the train step (twin of ``ieagan_tpu/train/optim.py``).

Adam with betas (B1, B2) = (0, 0.999), eps 1e-6 and no weight decay
(reference: model.py:410-416, 858-864). ``torch.optim.Adam`` makes the same
update as ``optax.adam``: bias-corrected moments, ``eps`` outside the square
root. Only the constant ``"default"`` schedule is ported; the cosine
schedules, gradient clipping, AMSGrad and AdaBelief raise.
"""

from __future__ import annotations

import torch


def make_optimizer(params, lr: float, b1: float, b2: float, eps: float,
                   sched_version: str | None = "default", clip_norm: float | None = None,
                   amsgrad: bool = False, ada_belief: bool = False) -> torch.optim.Adam:
    """Adam over ``params`` at the constant learning rate ``lr``."""
    if sched_version not in ("default", None):
        raise NotImplementedError(f"LR schedule {sched_version!r} is not ported")
    if clip_norm is not None:
        raise NotImplementedError("gradient clipping (clip_norm) is not ported")
    if amsgrad or ada_belief:
        raise NotImplementedError("AMSGrad and AdaBelief are not ported")
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps, weight_decay=0.0)


def make_optimizers(G, D, config: dict):
    """``(opt_G, opt_D)`` for the generator and discriminator from the
    config's G_lr/D_lr, G_B1/G_B2/D_B1/D_B2 and adam_eps."""
    common = dict(eps=float(config["adam_eps"]),
                  sched_version=config.get("sched_version", "default"),
                  clip_norm=config.get("clip_norm"),
                  amsgrad=bool(config.get("amsgrad", False)),
                  ada_belief=bool(config.get("ada_belief", False)))
    opt_G = make_optimizer(G.parameters(), float(config["G_lr"]), float(config["G_B1"]),
                           float(config["G_B2"]), **common)
    opt_D = make_optimizer(D.parameters(), float(config["D_lr"]), float(config["D_B1"]),
                           float(config["D_B2"]), **common)
    return opt_G, opt_D
