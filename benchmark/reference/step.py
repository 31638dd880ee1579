"""Plain PyTorch reference of IEA-GAN's train step.

One step, as the published training function takes it (IEA-GAN's
`train_fns.py`, `loss.py`, `diff_aug.py`):

  D phase  G(z, y) in train mode without gradient; DiffAugment on the fakes
           and on the reals; D's fake pass, then its real pass; loss =
           hinge + contra_lambda * 2C(embed_r, proxy_r) + unif_lambda *
           uniformity(embed_r); Adam on D.
  G phase  G(z', y) with gradient; DiffAugment on the fakes; D's pass (its
           weights take no gradient); loss = -mean(score) + contra_lambda *
           2C(embed_f, proxy_f) + IEA_lambda * KL(real || fake similarity)
           + unif_lambda * uniformity(embed_f); the orthogonal regulariser
           G_ortho * 2 ((W W^T) o (1 - I)) W added to each matrix's gradient
           (the class embedding left out); Adam on G.
  EMA      G_ema = decay G_ema + (1 - decay) G, decay 0 before ema_start.

Adam is optax's: mu, nu, bias correction by the step count, eps outside the
square root. Every random number is an input (``draws``), in the order the
step takes them. Everything computes in float32; the products run through
``model.Ops``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import model

BUFFER_SUFFIXES = (".u", ".sv", ".mean", ".var", ".accumulation_counter")


def is_param(name: str) -> bool:
    return not name.endswith(BUFFER_SUFFIXES)


# ----------------------------------------------------------------------------
# DiffAugment over NHWC images, with explicit draws

def diff_augment(x, d):
    b, h, w, _ = x.shape
    col = lambda n: d[n].float()[:, None, None, None]
    x = x + col("brightness")
    mean = x.mean(dim=-1, keepdim=True)
    x = (x - mean) * col("saturation") + mean
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    x = (x - mean) * col("contrast") + mean
    # translation: out[i, j] = x[i + t_h, j + t_w], zero outside
    rows = torch.arange(h, device=x.device)[None, :] + d["t_h"][:, None]
    cols = torch.arange(w, device=x.device)[None, :] + d["t_w"][:, None]
    keep = (((rows >= 0) & (rows < h))[:, :, None] & ((cols >= 0) & (cols < w))[:, None, :])
    bi = torch.arange(b, device=x.device)[:, None, None]
    x = x[bi, rows.clamp(0, h - 1)[:, :, None], cols.clamp(0, w - 1)[:, None, :]]
    x = x * keep[..., None].float()
    # cutout: a box of half the image's size centred at (off_h, off_w)
    ch, cw = int(h * 0.5 + 0.5), int(w * 0.5 + 0.5)
    r = torch.arange(h, device=x.device)[None, :, None]
    c = torch.arange(w, device=x.device)[None, None, :]
    top = (d["off_h"] - ch // 2)[:, None, None]
    left = (d["off_w"] - cw // 2)[:, None, None]
    box = (r >= top) & (r < top + ch) & (c >= left) & (c < left + cw)
    return x * (~box)[..., None].float()


# ----------------------------------------------------------------------------
# losses

def hinge_d(score_f, score_r):
    return F.relu(1.0 - score_r).mean(), F.relu(1.0 + score_f).mean()


def contrastive(embed, proxy, temperature=1.0):
    """2C: -mean log(exp(e_i p_i / t) / (exp(e_i p_i / t) + sum_{j != i}
    exp(e_i e_j / t))), rows taken to unit length."""
    unit = lambda t: t / torch.clamp(t.norm(dim=-1, keepdim=True), min=1e-8)
    e, p = unit(embed), unit(proxy)
    n = e.shape[0]
    sim = torch.exp(e @ e.T / temperature) * (1.0 - torch.eye(n, device=e.device))
    pos = torch.exp((e * p).sum(-1) / temperature)
    return -torch.log(temperature * pos / (pos + sim.sum(1))).mean()


def uniformity(x, t=2.0):
    """log of the mean over pairs i < j of exp(-t |x_i - x_j|^2)."""
    n = x.shape[0]
    iu = torch.triu_indices(n, n, 1, device=x.device)
    d2 = ((x[iu[0]] - x[iu[1]]) ** 2).sum(-1)
    return torch.log(torch.exp(-t * d2).mean())


def iea(k_f, k_r):
    """KL(softmax(k_r k_r^T) || softmax(k_f k_f^T)), rows summed, over the
    batch (the real side held constant)."""
    k_r = k_r.detach()
    log_pf = torch.log_softmax(k_f @ k_f.T, -1)
    log_pr = torch.log_softmax(k_r @ k_r.T, -1)
    return (log_pr.exp() * (log_pr - log_pf)).sum() / k_f.shape[0]


# ----------------------------------------------------------------------------
# optimiser and regulariser

def ortho_grad(name, w, strength):
    if w.ndim < 2 or name.startswith("shared."):
        return None
    m = w.reshape(w.shape[0], -1)
    gram = (m @ m.T) * (1.0 - torch.eye(m.shape[0], device=m.device))
    return (strength * 2.0 * (gram @ m)).reshape(w.shape)


class Adam:
    """optax.adam(lr, b1, b2, eps) over a dict of tensors."""

    def __init__(self, params: dict, b1, b2, eps):
        self.b1, self.b2, self.eps, self.count = b1, b2, eps, 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict, lr):
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        for k, p in params.items():
            g = grads[k]
            self.mu[k] = self.b1 * self.mu[k] + (1.0 - self.b1) * g
            self.nu[k] = self.b2 * self.nu[k] + (1.0 - self.b2) * g * g
            p -= lr * (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + self.eps)


# ----------------------------------------------------------------------------
# the step

class Trainer:
    """G, D, G_ema and both optimisers from state dicts ``SG`` and ``SD``
    (copied). ``step(x, y, draws)`` takes the reals, the labels and the
    step's draws: D phase z (, rdof), the fakes' and the reals' DiffAugment
    draws; G phase z (, rdof), the fakes' draws."""

    def __init__(self, cfg, SG, SD, ops: model.Ops, recompute: bool = False):
        self.cfg, self.ops, self.recompute = cfg, ops, recompute
        self.SG = {k: v.detach().clone().float() for k, v in SG.items()}
        self.SD = {k: v.detach().clone().float() for k, v in SD.items()}
        self.G_ema = {k: v.clone() for k, v in self.SG.items()}
        self.pG = {k: v for k, v in self.SG.items() if is_param(k)}
        self.pD = {k: v for k, v in self.SD.items() if is_param(k)}
        eps = cfg["adam_eps"]
        self.opt_G = Adam(self.pG, cfg["G_B1"], cfg["G_B2"], eps)
        self.opt_D = Adam(self.pD, cfg["D_B1"], cfg["D_B2"], eps)
        self.itr = 0

    def _grads(self, loss, params: dict):
        keys = [k for k, v in params.items() if v.requires_grad]
        got = torch.autograd.grad(loss, [params[k] for k in keys], allow_unused=True)
        out = {k: torch.zeros_like(v) for k, v in params.items()}
        out.update({k: g for k, g in zip(keys, got) if g is not None})
        return out

    def step(self, x, y, draws):
        cfg, ops, rc = self.cfg, self.ops, self.recompute
        draws = list(draws)
        take = lambda: draws.pop(0)
        rdof_on = cfg["RRM_prx_G"]
        mets = {}

        # D phase
        for v in self.pD.values():
            v.requires_grad_(True)
        z = take()
        rdof = take() if rdof_on else None
        with torch.no_grad():
            fake = model.generator(cfg, self.SG, z, y, rdof, ops, train=True)
        fake = diff_augment(fake, take())
        real = diff_augment(x.float(), take())
        _, _, score_f = model.discriminator(cfg, self.SD, fake, y, ops, recompute=rc)
        proxy_r, embed_r, score_r = model.discriminator(cfg, self.SD, real, y, ops, recompute=rc)
        loss_real, loss_fake = hinge_d(score_f, score_r)
        unif_d = uniformity(embed_r)
        d_loss = (loss_real + loss_fake + cfg["contra_lambda"] * contrastive(embed_r, proxy_r)
                  + cfg["unif_lambda"] * unif_d)
        grads_D = self._grads(d_loss, self.pD)
        for v in self.pD.values():
            v.requires_grad_(False)
        self.opt_D.step(self.pD, grads_D, cfg["D_lr"])
        mets.update(D_loss_real=loss_real.item(), D_loss_fake=loss_fake.item(),
                    unif_loss_d=unif_d.item())
        embed_real = embed_r.detach()
        del fake, real, proxy_r, embed_r, score_r, score_f

        # G phase
        for v in self.pG.values():
            v.requires_grad_(True)
        z = take()
        rdof = take() if rdof_on else None
        fake = model.generator(cfg, self.SG, z, y, rdof, ops, train=True, recompute=rc)
        fake = diff_augment(fake, take())
        proxy_f, embed_f, score_f = model.discriminator(cfg, self.SD, fake, y, ops, recompute=rc)
        iea_l = iea(embed_f, embed_real)
        unif_g = uniformity(embed_f)
        g_loss = (-score_f.mean() + cfg["contra_lambda"] * contrastive(embed_f, proxy_f)
                  + cfg["IEA_lambda"] * iea_l + cfg["unif_lambda"] * unif_g)
        grads_G = self._grads(g_loss, self.pG)
        for v in self.pG.values():
            v.requires_grad_(False)
        for k, v in self.pG.items():
            term = ortho_grad(k, v, cfg["G_ortho"])
            if term is not None:
                grads_G[k] = grads_G[k] + term
        self.opt_G.step(self.pG, grads_G, cfg["G_lr"])
        mets.update(iea_loss=iea_l.item(), unif_loss_g=unif_g.item(), G_loss=g_loss.item())

        # EMA
        self.itr += 1
        decay = 0.0 if self.itr < cfg["ema_start"] else cfg["ema_decay"]
        with torch.no_grad():
            for k, v in self.SG.items():
                self.G_ema[k] = self.G_ema[k] * decay + v * (1.0 - decay)
        return mets, grads_G, grads_D
