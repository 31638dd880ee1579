"""Losses of the train step (twin of ``ieagan_tpu/losses/__init__.py``;
reference: loss.py:8-132): hinge, conditional contrastive (2C),
intra-event-aware KL, hypersphere uniformity and the l2 consistency loss.

Pure functions over scores and embeddings; every reduction runs in float32.
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
