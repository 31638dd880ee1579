"""Reference numbers of the JAX package's InceptionV3 features, and the check
of the port against them.

``golden_inception.json`` records what the JAX package's
``InceptionV3Features`` computes on the CPU with the port's fallback weights
``init_feature_weights(seed)`` (passed through
``ieagan_tpu.eval.inception.convert_torch_state_dict``) for ``N_IMAGES``
numpy-seeded 299x299 inputs: each image's feature L2 norm, and the features
at fixed (image, feature) positions. The file is written and re-checked by
``tests/test_torch_inception.py`` (``--write``); ``chip_smoke.py`` holds the
port's features on the card against it.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

GOLDEN_PATH = Path(__file__).resolve().with_name("golden_inception.json")
N_IMAGES = 8
N_ENTRIES = 256

# Bounds, relative to each image's feature norm (f32 on both sides, TF32 off
# on the card; the sides differ in summation order through 94 convolutions).
# Readings (PERF.md): norms within 1.5e-6 on the CPU and 3.0e-7 on the
# H100, entries within 1.3e-7 and 5.5e-8. The control, the same weights on
# the other half of the images, is off by 0.76 (norms) and 0.047 (entries):
# 1e-4 sits 65x above the worst sound reading and 470x below the control.
NORM_RTOL = 1e-4
ENTRY_RTOL = 1e-4


def inputs(seed: int, n: int = N_IMAGES) -> np.ndarray:
    """(n, 3, 299, 299) float32 in [0, 1] from ``np.random.default_rng(seed)``:
    uniform noise, each image scaled by its own factor in [0.1, 1], so that
    the images' features differ enough for the control to break the bounds."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, 3, 299, 299), dtype=np.float32)
    return x * rng.uniform(0.1, 1.0, (n, 1, 1, 1)).astype(np.float32)


def entry_index(seed: int, n: int = N_IMAGES, count: int = N_ENTRIES) -> np.ndarray:
    """``count`` fixed (image, feature) positions, from
    ``np.random.default_rng(seed + 1)``."""
    rng = np.random.default_rng(seed + 1)
    return np.stack([rng.integers(0, n, count), rng.integers(0, 2048, count)], axis=1)


def summarize(feats: np.ndarray, index: np.ndarray) -> dict:
    """Per-image feature norms of ``feats`` (n, 2048), and its values at
    ``index``."""
    feats = np.asarray(feats, np.float64)
    return {"norm": np.linalg.norm(feats, axis=1).tolist(),
            "entries": feats[index[:, 0], index[:, 1]].tolist()}


def compare(golden: dict, feats: np.ndarray, images=None) -> dict:
    """Worst differences of the features ``feats`` (m, 2048) of the golden
    images ``images`` (all by default) from the file, relative to each
    image's norm there, and whether each is within its bound."""
    feats = np.asarray(feats, np.float64)
    want_norm = np.asarray(golden["norm"])
    images = np.arange(len(want_norm)) if images is None else np.asarray(images)
    norm_rel = float(np.max(np.abs(np.linalg.norm(feats, axis=1) - want_norm[images])
                            / want_norm[images]))
    index, want = np.asarray(golden["index"]), np.asarray(golden["entries"])
    pick = np.isin(index[:, 0], images)
    row = {int(img): i for i, img in enumerate(images)}
    got = feats[[row[int(i)] for i in index[pick, 0]], index[pick, 1]]
    entry_rel = float(np.max(np.abs(got - want[pick]) / want_norm[index[pick, 0]]))
    return {"norm_max_rel": norm_rel, "norm_ok": norm_rel <= NORM_RTOL,
            "entry_max_rel": entry_rel, "entry_ok": entry_rel <= ENTRY_RTOL}


def load() -> dict:
    with open(GOLDEN_PATH, encoding="utf-8") as fp:
        return json.load(fp)
