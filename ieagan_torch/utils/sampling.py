"""Latent and label samplers, sample sheets, interpolation, standing stats
(twin of ``ieagan_tpu/utils/sampling.py``; reference: utils/__init__.py).

  * ``sample_z``/``sample_y``: z from normal / censored_normal / bernoulli /
    truncated_normal, y categorical or a fresh permutation per event (the
    training default: every batch holds each sensor once);
  * ``trunc_trick``: z resampled into (-bound, bound) for a fixed number of
    rounds, then clipped (the JAX package's ``eval/fid.py::trunc_trick``);
  * ``accumulate_standing_stats``: reset the generator's batch-norm stats and
    accumulate batch moments over fresh noise (utils/__init__.py:278-296);
  * ``sample_sheet``, ``interp``, ``interp_sheet`` (utils/__init__.py:419-545)
    and ``generate_images`` (PNG dump, 899-942).

Every random number comes from the caller's ``torch.Generator`` (on the
generator module's device). The generator's rdof, which the JAX model draws
inside, is drawn here. ``dtype`` is the compute type of the latents, as the
JAX package's generator built under a dtype policy computes.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from ieagan_torch.ops.image_norm import denorm


def _device(G) -> torch.device:
    return next(G.parameters()).device


def draw_device(generator: torch.Generator | None, device=None) -> torch.device:
    """Where a sampler draws: ``device`` when given, else the device of the
    ``torch.Generator``, else the GPU (the port runs on the CPU only when
    asked to)."""
    if device is not None:
        return torch.device(device)
    return generator.device if generator is not None else torch.device("cuda")


def trunc_trick(generator: torch.Generator | None, shape, bound: float = 1.0,
                max_iters: int = 16, device=None):
    """Normal draws resampled into (-bound, bound) ``max_iters`` times, then
    clipped (reference: utils/__init__.py:880-884). ``device``: see
    ``draw_device``."""
    device = draw_device(generator, device)
    z = torch.randn(shape, generator=generator, device=device)
    for _ in range(max_iters):
        fresh = torch.randn(shape, generator=generator, device=device)
        z = torch.where((z > -bound) & (z < bound), z, fresh)
    return torch.clamp(z, -bound, bound)


def sample_z(generator: torch.Generator | None, batch: int, dim_z: int,
             z_dist: str = "normal", z_var: float = 1.0, threshold: float = 1.0,
             device=None):
    """z over the reference's z_dist surface (utils/__init__.py:85-97).
    ``device``: see ``draw_device``."""
    device = draw_device(generator, device)
    if z_dist == "normal":
        return torch.randn((batch, dim_z), generator=generator, device=device) * z_var ** 0.5
    if z_dist == "censored_normal":
        return torch.relu(torch.randn((batch, dim_z), generator=generator, device=device)
                          * z_var ** 0.5)
    if z_dist == "bernoulli":
        return (torch.rand((batch, dim_z), generator=generator, device=device) < 0.5).float()
    if z_dist == "truncated_normal":
        return trunc_trick(generator, (batch, dim_z), bound=threshold, device=device)
    raise NotImplementedError(f"z_dist {z_dist!r}")


def sample_y(generator: torch.Generator | None, n_classes: int, events: int = 1,
             y_dist: str = "permuted", device=None):
    """y: 'permuted' gives each event a fresh permutation of all classes (the
    intra-event training contract, utils/__init__.py:98-106); 'categorical'
    is iid classes. ``device``: see ``draw_device``."""
    device = draw_device(generator, device)
    if y_dist == "permuted":
        return torch.cat([torch.randperm(n_classes, generator=generator, device=device)
                          for _ in range(events)]).long()
    if y_dist == "categorical":
        return torch.randint(0, n_classes, (n_classes * events,), generator=generator,
                             device=device)
    raise NotImplementedError(f"y_dist {y_dist!r}")


def _latents(G, config, generator, n: int, dtype, z=None):
    device = _device(G)
    if z is None:
        z = torch.randn((n, int(config["dim_z"])), generator=generator, device=device)
    rdof = torch.randn((n, int(config["rdof_dim"])), generator=generator, device=device)
    return z.to(dtype), rdof


@contextlib.contextmanager
def eval_mode(module: torch.nn.Module):
    """``module`` in eval mode (batch norm from its stats, spectral-norm
    vectors not written) for the block, then back in its mode."""
    training = module.training
    module.eval()
    try:
        yield module
    finally:
        module.train(training)


@torch.no_grad()
def _images(G, z, y, rdof, accumulate_standing: bool = False):
    """Generator output in eval mode, in f32 ADU, (B, H-6, W), on the host."""
    with eval_mode(G):
        return denorm(G(z, y, rdof, accumulate_standing).float())[..., 0].cpu().numpy()


@torch.no_grad()
def accumulate_standing_stats(G, config, generator: torch.Generator | None,
                              num_accumulations: int = 16, dtype=torch.float32):
    """Reset ``G``'s batch-norm stats and accumulate batch moments over
    ``num_accumulations`` fresh draws of one event each (random classes), in
    place; ``G`` is left in eval mode, where it divides by the counters. The
    spectral-norm vectors keep their values, as the JAX package's
    accumulation returns only the batch stats."""
    es = int(config["n_classes"])
    device = _device(G)
    spectral = {k: v.clone() for k, v in G.state_dict().items()
                if k.rsplit(".", 1)[-1] in ("u", "sv")}
    for name, buf in G.named_buffers():
        if name.rsplit(".", 1)[-1] in ("mean", "var", "accumulation_counter"):
            buf.zero_()
    G.train()
    for _ in range(num_accumulations):
        z, rdof = _latents(G, config, generator, es, dtype)
        y = torch.randint(0, es, (es,), generator=generator, device=device)
        G(z, y, rdof, accumulate_standing=True)
        G.load_state_dict(spectral, strict=False)
    G.eval()
    return G


def sample_sheet(G, config, generator: torch.Generator | None, samples_per_class: int = 10,
                 dtype=torch.float32, accumulate_standing: bool = False) -> np.ndarray:
    """Per-class sample sheet: (n_classes, samples_per_class, H-6, W) ADU
    (reference: utils/__init__.py:419-476)."""
    es = int(config["n_classes"])
    y = torch.arange(es, device=_device(G))
    sheets = []
    for _ in range(samples_per_class):
        z, rdof = _latents(G, config, generator, es, dtype)
        sheets.append(_images(G, z, y, rdof, accumulate_standing))
    return np.stack(sheets, axis=1)


def interp(x0, x1, num_midpoints: int):
    """Linear interpolation grid (reference: utils/__init__.py:480-490):
    (B, ...) endpoints -> (B, num_midpoints+2, ...)."""
    lerp = torch.linspace(0.0, 1.0, num_midpoints + 2, device=x0.device, dtype=x0.dtype)
    lerp = lerp.reshape((1, num_midpoints + 2) + (1,) * (x0.ndim - 1))
    return x0[:, None] * (1.0 - lerp) + x1[:, None] * lerp


def interp_sheet(G, config, generator: torch.Generator | None, num_midpoints: int = 8,
                 fix_z: bool = False, fix_y: bool = True, dtype=torch.float32,
                 accumulate_standing: bool = False) -> np.ndarray:
    """Latent-interpolation sheet (reference: utils/__init__.py:494-545):
    (n_classes, num_midpoints+2, H-6, W) ADU images."""
    es, dim_z = int(config["n_classes"]), int(config["dim_z"])
    device = _device(G)
    steps = num_midpoints + 2
    z0 = torch.randn((es, dim_z), generator=generator, device=device)
    if fix_z:
        z = z0[:, None].expand(es, steps, dim_z)
    else:
        z = interp(z0, torch.randn((es, dim_z), generator=generator, device=device),
                   num_midpoints)
    y = torch.arange(es, device=device)[:, None].expand(es, steps).reshape(-1)
    z, rdof = _latents(G, config, generator, es * steps, dtype, z=z.reshape(-1, dim_z))
    imgs = _images(G, z, y, rdof, accumulate_standing)
    return imgs.reshape(es, steps, *imgs.shape[1:])


def generate_images(out_dir: str, G, config, generator: torch.Generator | None,
                    n_images: int, dtype=torch.float32) -> int:
    """Dump generated images as PNGs (reference: utils/__init__.py:899-942);
    ``trunc_z`` and ``denoise`` honoured from the config (denoise needs cv2
    and is skipped, with a message, without it)."""
    from PIL import Image
    es, dim_z = int(config["n_classes"]), int(config["dim_z"])
    z_bound = float(config.get("trunc_z", 0.0) or 0.0)
    device = _device(G)
    y = torch.arange(es, device=device)
    os.makedirs(out_dir, exist_ok=True)
    denoise = bool(config.get("denoise", False))
    try:
        import cv2  # noqa: F401
    except ImportError:
        if denoise:
            print("cv2 unavailable; skipping denoise")
        denoise = False
    count = 0
    while count < n_images:
        z = (trunc_trick(generator, (es, dim_z), bound=z_bound, device=device)
             if z_bound > 0.0 else None)
        z, rdof = _latents(G, config, generator, es, dtype, z=z)
        for img in _images(G, z, y, rdof):
            if count >= n_images:
                break
            arr = img.astype(np.uint8)
            if denoise:
                import cv2
                arr = cv2.fastNlMeansDenoising(
                    src=arr, dst=None, h=config.get("denoise_str_lum", 3),
                    templateWindowSize=config.get("denoise_kernel_size", 7),
                    searchWindowSize=config.get("denoise_search_window", 21))
            Image.fromarray(arr, mode="L").save(os.path.join(out_dir, f"image_{count:05d}.png"))
            count += 1
    return count
