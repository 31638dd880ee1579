"""Data-domain normalization transforms (twin of ``ieagan_tpu/ops/image_norm.py``;
reference: utils/norm.py:8-46).

Detector images are log-ADU transformed: [0, 255] ADU maps through
log(255x+1)/log(256) (x in [0, 1]) and is trained in [-1, 1]. The inverse is
256^x - 1 with a clamp and the 256 -> 250 row crop.
"""

from __future__ import annotations

import math

import torch

_LOG256 = math.log(256.0)


def lognorm255(x):
    """[0,1] -> [0,1] log transform (reference: utils/norm.py:8-19)."""
    return torch.log(255.0 * x + 1.0) / _LOG256


def lognorm(x):
    """uint8-range [0,255] -> [0,1] (reference: utils/norm.py:22-31)."""
    return torch.log(x + 1.0) / _LOG256


def denorm(x):
    """Model output [-1,1] (N,H,W,1) -> ADU [0,255] with row crop 3:-3
    (reference: utils/norm.py:34-46)."""
    out = torch.clamp(torch.pow(256.0, x * 0.5 + 0.5) - 1.0, 0.0, 255.0)
    return out[:, 3:-3, :, :]


def generate_postprocess(imgs, threshold: float = -0.26):
    """The deployment postprocess contract (reference: model.py:1140-1148 /
    ieagan.py:1343-1366): threshold low amplitudes to -1 ("cut the noise
    below 7 ADU"), map to ADU, crop rows, squeeze the channel.

    imgs: (N, 256, W, 1) in [-1, 1] -> (N, 250, W) in [0, 255].
    """
    imgs = torch.where(imgs > threshold, imgs, torch.full_like(imgs, -1.0))
    imgs = torch.clamp(torch.pow(256.0, imgs * 0.5 + 0.5) - 1.0, 0.0, 255.0)
    return imgs[:, 3:-3, :, 0]
