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


def device_event_transform(raw_u8, generator: torch.Generator | None = None,
                           noise_scale: float = 4e-3, pad: int = 3,
                           rows: tuple[int, int] | None = None):
    """Raw uint8 sensor images (B, H, W) -> (B, H+2*pad, W, 1) float32 in
    [-1, 1] on their device (twin of ``ieagan_tpu/ops/image_norm.py:48-65``
    and of ``data/dataset.py::event_transform_stack``): pad, lognorm,
    [-1, 1], plus U[0, 2*noise_scale) pixel noise drawn from ``generator``
    (the host chain draws it from numpy; same distribution). With uint8
    batches the host uploads a quarter of the bytes. ``rows=(start,
    total)``: the batch is rows ``start..start+B`` of a global batch of
    ``total``, and the noise is drawn for the global batch and cut to them
    (data parallel, ``parallel/sharding.py``)."""
    x = torch.nn.functional.pad(raw_u8.float(), (0, 0, pad, pad))
    out = 2.0 * (torch.log(x + 1.0) / _LOG256) - 1.0
    if noise_scale:
        start, total = rows or (0, out.shape[0])
        noise = torch.rand((total, *out.shape[1:]), generator=generator, device=out.device)
        out = out + (2.0 * noise_scale) * noise[start:start + out.shape[0]]
    return out[..., None]
