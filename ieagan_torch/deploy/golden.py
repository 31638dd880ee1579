"""Reference numbers of the JAX package's ``best0`` event, and the check of the
port against them.

``golden_best0.json`` records, for one event whose z and rdof are drawn from
``np.random.default_rng(seed)`` (z first, then rdof, both standard normal
float32), what the JAX package's ``Model.restore("artifacts/flagship_r4b",
tag="best0")`` generates on the CPU: the per-sensor ADU sums and nonzero-pixel
counts of the (40, 250, 768) event, and the generator's tanh output at fixed
pixels. The file is written and re-checked by ``tests/test_torch_golden.py``;
``chip_smoke.py`` holds the port's event on the card against it.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

GOLDEN_PATH = Path(__file__).resolve().with_name("golden_best0.json")

# Tolerances, fixed before the first comparison on the card. Both sides run
# the generator in fp32 (TF32 off on the card) and differ only in summation
# order through 13 convolutions and 26 normalizations.
#  * tanh pixels: 5e-4 abs, the bound the JAX package holds its generator to
#    against the reference PyTorch model (tests/test_model_parity.py).
#  * ADU sums: 1e-3 relative. A pixel whose tanh value lies within the tanh
#    tolerance of the -0.26 threshold may land on either side (0 vs ~6.8
#    ADU), besides the 256^x amplification of tanh differences.
#  * nonzero counts: at most 0.1% of the pixels of a sensor image
#    (192 of 192,000) may flip across the threshold.
TANH_ATOL = 5e-4
ADU_SUM_RTOL = 1e-3
NONZERO_ATOL = 192


def load() -> dict:
    with open(GOLDEN_PATH, encoding="utf-8") as fp:
        return json.load(fp)


def inputs(seed: int, event_size: int = 40, dim_z: int = 128, rdof_dim: int = 4):
    """The golden event's ``(z, rdof)`` as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((event_size, dim_z), dtype=np.float32)
    rdof = rng.standard_normal((event_size, rdof_dim), dtype=np.float32)
    return z, rdof


def pixel_index(seed: int, shape, count: int = 256) -> np.ndarray:
    """``count`` fixed (image, row, col) positions of a tanh output of
    ``shape`` (N, H, W), drawn from ``np.random.default_rng(seed + 1)``."""
    rng = np.random.default_rng(seed + 1)
    return np.stack([rng.integers(0, s, count) for s in shape], axis=1)


def summarize(tanh: np.ndarray, events: np.ndarray, index: np.ndarray) -> dict:
    """Per-sensor ADU sums and nonzero counts of ``events`` (N, 250, W), and
    the values of ``tanh`` (N, H, W, 1) at ``index``."""
    flat = events.reshape(events.shape[0], -1).astype(np.float64)
    return {
        "adu_sum": flat.sum(axis=1).tolist(),
        "nonzero": (flat > 0).sum(axis=1).astype(int).tolist(),
        "tanh": tanh[index[:, 0], index[:, 1], index[:, 2], 0].astype(float).tolist(),
    }


def compare(golden: dict, summary: dict) -> dict:
    """Worst differences of ``summary`` from ``golden`` and whether each is
    within its tolerance."""
    tanh_err = float(np.max(np.abs(np.subtract(summary["tanh"], golden["tanh"]))))
    want_sum = np.asarray(golden["adu_sum"])
    sum_rel = float(np.max(np.abs(np.asarray(summary["adu_sum"]) - want_sum)
                           / np.maximum(want_sum, 1.0)))
    nz_err = int(np.max(np.abs(np.subtract(summary["nonzero"], golden["nonzero"]))))
    return {
        "tanh_max_abs": tanh_err, "tanh_ok": tanh_err <= TANH_ATOL,
        "adu_sum_max_rel": sum_rel, "adu_sum_ok": sum_rel <= ADU_SUM_RTOL,
        "nonzero_max_abs": nz_err, "nonzero_ok": nz_err <= NONZERO_ATOL,
    }
