"""IEA-GAN in PyTorch for NVIDIA Hopper — the port of ``ieagan_tpu``.

A second package beside the JAX one, which stays the reference: each module
here is the twin of a module there and is tested against it. This package
imports ``torch``, ``numpy``, ``scipy`` and ``PIL`` only: never ``jax``,
``flax``, ``msgpack`` or ``ieagan_tpu``. The TPU's Pallas kernels become CUDA
kernels written for ``sm_90a`` under ``kernels/csrc``; each has a plain
PyTorch version beside it.

Layer map:
  core/      config surface (own copy of the JAX package's), dtype policy
  kernels/   CUDA kernels, their build (nvcc + ctypes), wrappers, plain versions
  ops/       spectral norm, (cc)BN, LayerNorm, attention dispatch, SA-GAN
             image attention, RRM, DiffAugment, data-domain norms
  models/    Generator, Discriminator, arch tables, carry-over of flax
             checkpoints and optimizer state, both ways
  losses/    hinge, conditional contrastive, IEA, uniformity
  data/      event dataset over the PNG tree, transforms, threaded loader
  train/     the D+G train step, optax-equivalent optimizers and schedules,
             ortho-reg, the run driver and its CLI (``train_torch.py``), the
             golden step check
  utils/     flax msgpack reader/writer, checkpoints, logs, run dirs, plots,
             sampling
  eval/      clean-FID/KID (InceptionV3, the metric's resize, reference stats),
             physics stats, the one-shot FID subprocess of the driver
  deploy/    generator-only inference (the basf2 deployment path) and the
             event producer (sparse digits through a C++ library, npz, basf2)
"""

from ieagan_torch.core.config import DEFAULT_CONFIG, event_size, load_config
from ieagan_torch.deploy.inference import (
    FROZEN_CONFIG, Model, generate, generate_batched, generate_block)
