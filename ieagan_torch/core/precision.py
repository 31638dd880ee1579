"""Dtype policy (twin of ``ieagan_tpu/core/precision.py``): f32 parameters,
optimizer state and statistics; convolutions and matmuls in the compute type.

The reference's mixed-precision flags are vestigial (reference:
model.py:398-416). The JAX package trains under a policy instead, bfloat16
by default (``core/config.py`` key ``compute_dtype``), and so does the port:
the train step casts the latents and the reals to the compute type, the
modules compute in their input's type, and batch-norm moments, softmax
statistics, losses, Adam and the EMA stay in float32.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype
    compute_dtype: torch.dtype


_POLICIES = {
    "bfloat16": Policy(param_dtype=torch.float32, compute_dtype=torch.bfloat16),
    "float32": Policy(param_dtype=torch.float32, compute_dtype=torch.float32),
}


def get_policy(name: str = "bfloat16") -> Policy:
    if name not in _POLICIES:
        raise ValueError(f"unknown compute dtype policy {name!r}")
    return _POLICIES[name]
