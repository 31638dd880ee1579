"""IEA-GAN in PyTorch for NVIDIA Hopper — the port of ``ieagan_tpu``.

A second package beside the JAX one, which stays the reference: each module
here is the twin of a module there and is tested against it. This package
imports ``torch`` and ``numpy`` only: never ``jax``, ``flax``, ``msgpack`` or
``ieagan_tpu``. The TPU's Pallas kernels become CUDA kernels written for
``sm_90a`` under ``kernels/csrc``; each has a plain PyTorch version beside it.

Layer map:
  core/      config surface (own copy of the JAX package's)
  kernels/   CUDA kernels, their build (nvcc + ctypes), wrappers, plain versions
  ops/       spectral norm, (cc)BN, LayerNorm, attention dispatch, SA-GAN
             image attention, RRM, DiffAugment, data-domain norms
  models/    Generator, Discriminator, arch tables, carry-over of flax
             checkpoints
  losses/    hinge, conditional contrastive, IEA, uniformity
  train/     the D+G train step, Adam, ortho-reg, the golden step check
  utils/     flax msgpack reader, checkpoint resolution and weight loading
  deploy/    generator-only inference (the basf2 deployment path)
"""

from ieagan_torch.core.config import DEFAULT_CONFIG, event_size, load_config
from ieagan_torch.deploy.inference import (
    FROZEN_CONFIG, Model, generate, generate_batched, generate_block)
