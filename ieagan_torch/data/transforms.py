"""Host-side image transforms (copy of ``ieagan_tpu/data/transforms.py``;
reference: utils/noise.py:6-116).

Numpy implementations of the noise and crop transforms; the uniform-noise
member of the training chain lives in dataset.event_transform, these cover
the rest of the reference's transform surface.
"""

from __future__ import annotations

import numpy as np


class UniformNoise:
    """Add U[0, scale) noise (reference: utils/noise.py:6-33)."""

    def __init__(self, scale: float = 4e-3, rng: np.random.Generator | None = None):
        self.scale = scale
        self.rng = rng or np.random.default_rng()

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return x + self.scale * self.rng.random(x.shape).astype(x.dtype)

    def __repr__(self):
        return f"UniformNoise(scale={self.scale})"


class GaussianNoise:
    """Add N(mean, std) noise (reference: utils/noise.py:36-70)."""

    def __init__(self, mean: float = 0.0, std: float = 1.0,
                 rng: np.random.Generator | None = None):
        self.mean = mean
        self.std = std
        self.rng = rng or np.random.default_rng()

    def __call__(self, x: np.ndarray) -> np.ndarray:
        noise = self.rng.standard_normal(x.shape).astype(x.dtype)
        return x + noise * self.std + self.mean

    def __repr__(self):
        return f"GaussianNoise(mean={self.mean}, std={self.std})"


class CenterCropLongEdge:
    """Center-crop (H, W[, C]) to a square on the long edge
    (reference: utils/noise.py:73-91)."""

    def __call__(self, img: np.ndarray) -> np.ndarray:
        h, w = img.shape[:2]
        size = min(h, w)
        top = (h - size) // 2
        left = (w - size) // 2
        return img[top:top + size, left:left + size]

    def __repr__(self):
        return self.__class__.__name__


class RandomCropLongEdge:
    """Random-position square crop on the long edge
    (reference: utils/noise.py:94-116)."""

    def __init__(self, rng: np.random.Generator | None = None):
        self.rng = rng or np.random.default_rng()

    def __call__(self, img: np.ndarray) -> np.ndarray:
        h, w = img.shape[:2]
        size = min(h, w)
        top = 0 if h == size else int(self.rng.integers(0, h - size))
        left = 0 if w == size else int(self.rng.integers(0, w - size))
        return img[top:top + size, left:left + size]

    def __repr__(self):
        return self.__class__.__name__


class BalancedSampler:
    """Yield index batches of n_classes x n_samples with class balance
    (reference: utils/__init__.py:161-215 BalancedBatchSampler — unused by
    the reference's train path, provided for surface parity)."""

    def __init__(self, labels, n_classes: int, n_samples: int,
                 rng: np.random.Generator | None = None):
        self.labels = np.asarray(labels)
        self.classes = np.unique(self.labels)
        self.n_classes = n_classes
        self.n_samples = n_samples
        self.rng = rng or np.random.default_rng()
        self.by_class = {c: np.flatnonzero(self.labels == c)
                         for c in self.classes}
        for idx in self.by_class.values():
            self.rng.shuffle(idx)
        self.cursor = {c: 0 for c in self.classes}

    def __iter__(self):
        count = 0
        batch_size = self.n_classes * self.n_samples
        while count + batch_size <= len(self.labels):
            chosen = self.rng.choice(self.classes, self.n_classes,
                                     replace=False)
            batch = []
            for c in chosen:
                pool = self.by_class[c]
                start = self.cursor[c]
                batch.extend(pool[start:start + self.n_samples])
                self.cursor[c] += self.n_samples
                if self.cursor[c] + self.n_samples > len(pool):
                    self.rng.shuffle(pool)
                    self.cursor[c] = 0
            yield batch
            count += batch_size

    def __len__(self):
        return len(self.labels) // (self.n_classes * self.n_samples)
