"""Losses (twin of ``ieagan_tpu/losses/__init__.py``; reference:
loss.py:8-293): hinge, conditional contrastive (2C and 2C+), the temperature
schedule, intra-event-aware KL, hypersphere uniformity, the l2 consistency
loss, and the gradient penalties no train loop calls (WGAN-GP, DRAGAN, the
latent gradient norm).

Pure functions over scores and embeddings; every reduction runs in float32.
The penalties take D (and G) as callables and their random draws as inputs.
They are first-order: one ``torch.autograd.grad`` without ``create_graph``,
as the JAX package computes them as values. Through a D with fused attention
that is all they can be, since ``FlashAttention``'s backward (B2) is not
itself differentiable and refuses ``create_graph=True``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def loss_hinge_dis(dis_fake, dis_real):
    """Hinge D loss -> (loss_real, loss_fake) (reference: loss.py:30-33)."""
    loss_real = torch.mean(F.relu(1.0 - dis_real.float()))
    loss_fake = torch.mean(F.relu(1.0 + dis_fake.float()))
    return loss_real, loss_fake


def loss_hinge_gen(dis_fake):
    """Hinge G loss (reference: loss.py:36-38)."""
    return -torch.mean(dis_fake.float())


def unif_loss(x, t: float = 2.0):
    """Hypersphere uniformity: log mean_{i<j} exp(-t ||xi-xj||²)
    (reference: loss.py:8-9, torch.pdist over unique pairs)."""
    x = x.float()
    n = x.shape[0]
    sq = torch.sum(x * x, dim=-1)
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (x @ x.T), min=0.0)
    upper = torch.ones((n, n), dtype=torch.bool, device=x.device).triu(1)
    vals = torch.where(upper, torch.exp(-t * d2), torch.zeros_like(d2))
    return torch.log(torch.sum(vals) / (n * (n - 1) / 2))


def iea_loss(k_f, k_r):
    """Intra-event-aware loss: KL(softmax(k_r k_rᵀ) || softmax(k_f k_fᵀ))
    with the real target detached, batchmean reduction (reference:
    loss.py:14-27)."""
    k_f = k_f.float()
    k_r = k_r.detach().float()
    logits_r = k_r @ k_r.T
    log_p_f = torch.log_softmax(k_f @ k_f.T, dim=-1)
    log_p_r = torch.log_softmax(logits_r, dim=-1)
    p_r = torch.softmax(logits_r, dim=-1)
    return torch.sum(p_r * (log_p_r - log_p_f)) / k_f.shape[0]


def l2_loss(a, b):
    """MSE consistency loss (reference: loss.py:41-44)."""
    return torch.mean(torch.square(a.float() - b.float()))


def make_mask(labels, n_cls: int):
    """(n_cls, B) 0/1 int mask of same-class membership (reference:
    utils/__init__.py:266-275)."""
    return (torch.arange(n_cls, device=labels.device)[:, None]
            == labels[None, :]).to(torch.int32)


def _unit_rows(x, eps: float = 1e-8):
    # torch.nn.CosineSimilarity semantics: norms clamped at eps
    x = x.float()
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=eps)


def conditional_contrastive_loss(inst_embed, proxy, negative_mask, labels,
                                 temperature: float, margin: float,
                                 pos_collected_numerator: bool = False):
    """2C conditional contrastive loss (reference: loss.py:79-132).

    inst_embed: (B, D) instance embeddings; proxy: (B, D) class proxies
    gathered by label; negative_mask: (n_cls, B) from ``make_mask``;
    labels: (B,).
    """
    b = inst_embed.shape[0]
    inst, prox = _unit_rows(inst_embed), _unit_rows(proxy)
    offdiag = ~torch.eye(b, dtype=torch.bool, device=inst.device)
    instance_zone = torch.where(offdiag, torch.exp((inst @ inst.T - margin) / temperature),
                                torch.zeros((), device=inst.device))
    inst2proxy = torch.exp((torch.sum(inst * prox, dim=-1) - margin) / temperature)
    numerator = inst2proxy
    if pos_collected_numerator:
        mask = negative_mask[labels] * offdiag
        numerator = numerator + torch.sum(instance_zone * mask, dim=1)
    denominator = inst2proxy + torch.sum(instance_zone, dim=1)
    return -torch.mean(torch.log(temperature * (numerator / denominator)))


def conditional_contrastive_loss_plus(inst_embed, proxy, negative_mask, labels,
                                      temperature: float, margin: float):
    """2C+ conditional contrastive loss: proxy-to-instance and
    instance-to-instance terms (reference: loss.py:135-190)."""
    inst, prox = _unit_rows(inst_embed), _unit_rows(proxy)
    p2i = torch.exp((prox @ inst.T - margin) / temperature)
    i2i = torch.exp((inst @ inst.T - margin) / temperature)
    mask = negative_mask[labels].float()  # (B, B)
    p2i_term = torch.sum(p2i * mask, dim=1) / torch.sum(p2i, dim=1)
    i2i_term = torch.sum(i2i * mask, dim=1) / torch.sum(i2i, dim=1)
    return (-torch.mean(torch.log(temperature * p2i_term))
            - torch.mean(torch.log(temperature * i2i_term)))


def set_temperature(conditional_strategy: str, tempering_type: str, start_temperature: float,
                    end_temperature: float, step_count: int, tempering_step: int,
                    total_step: int):
    """The contrastive temperature at ``step_count`` (reference: loss.py:47-76):
    ``"no"`` outside Contra, linear in the step (``continuous``), in
    ``tempering_step`` stairs (``discrete``), else ``start_temperature``."""
    if conditional_strategy != "Contra":
        return "no"
    if tempering_type == "continuous":
        return start_temperature + step_count * (end_temperature - start_temperature) / total_step
    if tempering_type == "discrete":
        interval = total_step // (tempering_step + 1)
        return (start_temperature + (step_count // interval)
                * (end_temperature - start_temperature) / tempering_step)
    return start_temperature


def _score(outs, conditional_strategy: str):
    return outs[2] if conditional_strategy == "Contra" else outs


def _penalty(d_apply, x, labels, conditional_strategy: str):
    """mean((||d score / d x|| - 1)^2) per sample, first order."""
    x = x.detach().requires_grad_()
    with torch.enable_grad():
        score = torch.sum(_score(d_apply(x, labels), conditional_strategy).float())
        (grads,) = torch.autograd.grad(score, x)
    gnorm = torch.sqrt(torch.sum(torch.square(grads.float().reshape(x.shape[0], -1)), dim=1)
                       + 1e-12)
    return torch.mean(torch.square(gnorm - 1.0))


def gradient_penalty(d_apply, real, fake, labels, alpha, conditional_strategy: str = "Contra"):
    """WGAN-GP penalty on ``alpha * real + (1 - alpha) * fake`` (reference:
    loss.py:193-229). ``d_apply(x, labels)`` is D; ``alpha`` (B, 1, 1, 1)
    uniform in [0, 1) is the caller's draw."""
    return _penalty(d_apply, alpha * real + (1 - alpha) * fake, labels, conditional_strategy)


def gradient_penalty_dragan(d_apply, real, labels, alpha, noise,
                            conditional_strategy: str = "Contra"):
    """DRAGAN penalty on ``real + alpha * 0.5 * std(real) * noise`` with the
    unbiased std (reference: loss.py:232-265). ``alpha`` (B, 1, 1, 1) and
    ``noise`` (real's shape) are the caller's uniform [0, 1) draws."""
    differences = 0.5 * torch.std(real, correction=1) * noise
    return _penalty(d_apply, real + alpha * differences, labels, conditional_strategy)


def latent_gradient_norm(g_apply, d_apply, z, labels, conditional_strategy: str = "Contra"):
    """The gradient of sum(D(G(z))) with respect to z and its squared norm
    per sample, ``(grads, norm (B, 1))`` (reference: loss.py:268-293)."""
    z = z.detach().requires_grad_()
    with torch.enable_grad():
        score = torch.sum(_score(d_apply(g_apply(z, labels), labels),
                                 conditional_strategy).float())
        (grads,) = torch.autograd.grad(score, z)
    return grads, torch.sum(torch.square(grads), dim=1)[:, None]
