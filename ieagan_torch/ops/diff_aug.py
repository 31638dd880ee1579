"""DiffAugment with explicit draws (twin of ``ieagan_tpu/ops/diff_aug.py:19-95``;
reference: diff_aug.py:10-109).

The JAX package draws inside the chain from a key; here the draws are an
input, a dict of per-image tensors of shape (B,):

  brightness   additive offset, U[-0.5, 0.5)
  saturation   factor, U[0, 2)
  contrast     factor, U[0.5, 1.5)
  t_h, t_w     integer shifts in [-round(H/8), round(H/8)] (and W)
  off_h, off_w integer cutout centres in [0, H + (1 - cut_h % 2)) (and W)

``sample_diff_aug_draws`` makes them from a ``torch.Generator``, so the step
controls every random number and a test can hand both frameworks the same
draws. The JAX package draws the three colour factors in the image's dtype
(``ieagan_tpu/ops/diff_aug.py:21,28,35``): under the bfloat16 policy the
fakes take bfloat16 draws, multiples of 2**-7, and the f32 reals f32 draws;
``dtype`` gives the port's draws the same granularity. Layout NHWC, as the
images the generator returns.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ieagan_torch.utils.sampling import draw_device

POLICY_DRAWS = {
    "color": ("brightness", "saturation", "contrast"),
    "translation": ("t_h", "t_w"),
    "cutout": ("off_h", "off_w"),
}
TRANSLATION_RATIO = 0.125
CUTOUT_RATIO = 0.5


def _policies(policy: str) -> list[str]:
    return [p for p in policy.split(",") if p] if policy else []


def _uniform(generator, b: int, device, dtype: torch.dtype):
    """U[0, 1) in ``dtype``: f32 from ``torch.rand``; a narrower float type
    as ``jax.random.uniform`` draws it, a multiple of 2**-mantissa bits."""
    if dtype == torch.float32:
        return torch.rand((b,), generator=generator, device=device)
    bits = round(-math.log2(torch.finfo(dtype).eps))
    k = torch.randint(0, 1 << bits, (b,), generator=generator, device=device)
    return k.to(dtype) * 2.0 ** -bits


def sample_diff_aug_draws(generator: torch.Generator | None, b: int, h: int, w: int,
                          policy: str = "color,translation,cutout", device=None,
                          dtype: torch.dtype = torch.float32) -> dict:
    """The draws ``diff_augment`` needs for a (b, h, w, c) batch of
    ``dtype`` images under ``policy``, from ``generator`` on ``device``
    (by default the generator's device, and the GPU without a generator)."""
    device = draw_device(generator, device)
    draws = {}
    uniform = lambda: _uniform(generator, b, device, dtype)
    for p in _policies(policy):
        if p == "color":
            draws["brightness"] = uniform() - 0.5
            draws["saturation"] = uniform() * 2.0
            draws["contrast"] = uniform() + 0.5
        elif p == "translation":
            sh, sw = int(h * TRANSLATION_RATIO + 0.5), int(w * TRANSLATION_RATIO + 0.5)
            draws["t_h"] = torch.randint(-sh, sh + 1, (b,), generator=generator, device=device)
            draws["t_w"] = torch.randint(-sw, sw + 1, (b,), generator=generator, device=device)
        elif p == "cutout":
            ch, cw = int(h * CUTOUT_RATIO + 0.5), int(w * CUTOUT_RATIO + 0.5)
            draws["off_h"] = torch.randint(0, h + (1 - ch % 2), (b,), generator=generator,
                                           device=device)
            draws["off_w"] = torch.randint(0, w + (1 - cw % 2), (b,), generator=generator,
                                           device=device)
        else:
            raise KeyError(f"unknown DiffAugment policy {p!r}")
    return draws


def _translation(x, t_h, t_w):
    """Per-image integer shift with zero fill: pad by 1 and clamp the shifted
    grid into the pad (reference: diff_aug.py:46-69)."""
    b, h, w, _ = x.shape
    x_pad = F.pad(x, (0, 0, 1, 1, 1, 1))
    rows = torch.clamp(torch.arange(h, device=x.device)[None, :] + t_h[:, None] + 1, 0, h + 1)
    cols = torch.clamp(torch.arange(w, device=x.device)[None, :] + t_w[:, None] + 1, 0, w + 1)
    batch = torch.arange(b, device=x.device)[:, None, None]
    return x_pad[batch, rows[:, :, None], cols[:, None, :]]


def _cutout(x, off_h, off_w):
    """Per-image zero box of half the image's size, centred at the draws and
    cut by the image's edges (reference: diff_aug.py:72-102)."""
    _, h, w, _ = x.shape
    ch, cw = int(h * CUTOUT_RATIO + 0.5), int(w * CUTOUT_RATIO + 0.5)
    rows = torch.arange(h, device=x.device)[None, :, None]
    cols = torch.arange(w, device=x.device)[None, None, :]
    top = (off_h - ch // 2)[:, None, None]
    left = (off_w - cw // 2)[:, None, None]
    box = (rows >= top) & (rows < top + ch) & (cols >= left) & (cols < left + cw)
    return x * (~box).to(x.dtype)[..., None]


def diff_augment(x, draws: dict, policy: str = "color,translation,cutout"):
    """The DiffAugment chain over NHWC images ``x`` with explicit ``draws``,
    in the policy's order (reference: diff_aug.py:10-20)."""
    col = lambda name: draws[name].to(x.dtype)[:, None, None, None]
    for p in _policies(policy):
        if p == "color":
            x = x + col("brightness")
            mean = x.mean(dim=-1, keepdim=True)
            x = (x - mean) * col("saturation") + mean
            mean = x.mean(dim=(1, 2, 3), keepdim=True)
            x = (x - mean) * col("contrast") + mean
        elif p == "translation":
            x = _translation(x, draws["t_h"], draws["t_w"])
        elif p == "cutout":
            x = _cutout(x, draws["off_h"], draws["off_w"])
        else:
            raise KeyError(f"unknown DiffAugment policy {p!r}")
    return x
