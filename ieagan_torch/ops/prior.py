"""Per-sensor physical prior features (twin of ``ieagan_tpu/ops/prior.py``;
reference: layers.prior, layers.py:16-29).

The reference reads ``features.csv`` (per-sensor occupancy and QED-background
features; column 8 is the mean occupancy) and L2-normalizes the gathered
batch vector over the batch axis. The csv is not in the upstream repository,
so the table is injectable: ``set_prior_features`` in code,
``load_prior_features(path)``, or the ``IEAGAN_PRIOR_FEATURES`` environment
variable naming a csv; with none of them the table is uniform, so the
``prior_embed`` ablation always builds.

The table is module state, as in the JAX package: the first
``prior_features`` call without a table set fixes it for the process, and
tests that compare the two packages must set it in both.
"""

from __future__ import annotations

import csv
import os

import numpy as np
import torch

_FEATURES: np.ndarray | None = None


def set_prior_features(values) -> None:
    """Use ``values`` (one feature per sensor) as the prior table."""
    global _FEATURES
    _FEATURES = np.asarray(values, np.float32).reshape(-1)


def load_prior_features(path: str = "features.csv", column: int = 8) -> np.ndarray:
    """Read column ``column`` of the csv at ``path`` (a header row, then one
    row per sensor; the reference takes ``iloc[:, 8]``) and set it as the
    prior table."""
    with open(path, newline="") as fp:
        rows = list(csv.reader(fp))
    values = np.array([float(row[column]) for row in rows[1:] if row], np.float32)
    set_prior_features(values)
    return values


def prior_features(y: torch.Tensor, n_classes: int, norm: bool = True) -> torch.Tensor:
    """The prior feature of each label in ``y``: (B, 1) f32 on ``y``'s
    device; with ``norm``, divided by its L2 norm over the batch (reference
    layers.py:26, ``F.normalize(dim=0)``)."""
    global _FEATURES
    if _FEATURES is None:
        env = os.environ.get("IEAGAN_PRIOR_FEATURES")
        if env and os.path.exists(env):
            load_prior_features(env)
        else:
            _FEATURES = np.ones(n_classes, np.float32)
    table = torch.as_tensor(_FEATURES[:n_classes], device=y.device)
    feats = table[y][:, None]
    if norm:
        feats = feats / torch.clamp(torch.linalg.vector_norm(feats), min=1e-12)
    return feats
