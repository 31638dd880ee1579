"""The state both sides start from, made on the device from the seed.

One draw of normal numbers covers every weight and every spectral-norm
vector, cut into the leaves of ``spec`` and scaled by each weight's fan-in;
biases, running means and counters are zero, gains, running variances and
logged singular values one, and each SA-GAN residual gain ``gamma`` is set
so that the attention's output reaches the next layer (the published
initialisation, zero, would leave it out of the forward and its weights
without gradient).
"""

from __future__ import annotations

import math

import torch

SA_GAMMA = 0.5


def make(spec: dict, seed: int, device, dtype=torch.float32) -> dict:
    """{name: tensor} for ``spec`` = {name: (shape, kind)} (``reference.model``)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    drawn = [(n, s) for n, (s, k) in spec.items() if k in ("weight", "u")]
    total = sum(math.prod(s) for _, s in drawn)
    flat = torch.randn((total,), generator=gen, device=device, dtype=dtype)
    out, at = {}, 0
    for name, (shape, kind) in spec.items():
        if kind in ("weight", "u"):
            n = math.prod(shape)
            t = flat[at:at + n].view(shape)
            at += n
            if kind == "weight":
                t = t * (1.0 / math.sqrt(max(1, n // shape[0])))
            out[name] = t
        elif kind == "zero":
            out[name] = torch.zeros(shape, device=device, dtype=dtype)
        elif kind == "one":
            out[name] = torch.ones(shape, device=device, dtype=dtype)
        elif kind == "gamma":
            out[name] = torch.full(shape, SA_GAMMA, device=device, dtype=dtype)
        else:
            raise ValueError(f"unknown kind {kind!r} of {name}")
    return out
