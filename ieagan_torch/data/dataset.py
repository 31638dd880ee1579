"""Event dataset: one item = all sensor images of one event (copy of
``ieagan_tpu/data/dataset.py``: numpy and PIL, the same arrays for the same
seed).

Directory layout (reference: utils/dataloader.py:14-53, README.md:14-27):
    <root>/1.1.1/<event_file>, <root>/1.1.2/<event_file>, ...
with identical filenames across the per-sensor subdirectories; subdir order
(sorted) defines the label order 0..n_sensors-1.

Transform chain (reference: utils/dataloader.py:69-78): pad height 3+3
(250 -> 256), grayscale, [0,1], lognorm255, +U[0,4e-3) noise,
normalize(0.5, 0.5) -> [-1, 1]. Implemented in numpy on the host; the
uniform noise uses a per-call numpy Generator so loader workers stay
deterministic under a seeded run.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None

_LOG256 = np.log(256.0)

# uint8 fast path: the pad -> /255 -> lognorm255 -> +noise -> normalize
# chain over a uint8 image has only 256 distinct deterministic values, so
# the whole arithmetic collapses to one table gather plus the scaled noise:
#   out = 2*log(k+1)/log(256) - 1 + 2*noise_scale*U[0,1)
# (pad rows are k=0 -> -1, noise applied everywhere, exactly as the
# composed chain does).
_U8_LUT = (2.0 * np.log(np.arange(256, dtype=np.float32) + 1.0)
           / _LOG256 - 1.0).astype(np.float32)


def event_transform(img: np.ndarray, rng: np.random.Generator | None = None,
                    noise_scale: float = 4e-3) -> np.ndarray:
    """(H, W) uint8/float -> (H+6, W, 1) float32 in [-1, 1]."""
    x = np.asarray(img)
    if x.dtype == np.uint8 and x.ndim == 2:
        return event_transform_stack(x[None], rng, noise_scale)[0]
    x = x.astype(np.float32)
    if x.ndim == 3:  # RGB -> luminance (transforms.Grayscale semantics)
        x = x @ np.array([0.299, 0.587, 0.114], np.float32)
    x = np.pad(x, ((3, 3), (0, 0)))
    x = x / 255.0
    x = np.log(255.0 * x + 1.0) / _LOG256
    if rng is not None and noise_scale:
        x = x + noise_scale * rng.random(x.shape, np.float32)
    x = (x - 0.5) / 0.5
    return x[..., None].astype(np.float32)


def event_transform_stack(imgs: np.ndarray,
                          rng: np.random.Generator | None = None,
                          noise_scale: float = 4e-3) -> np.ndarray:
    """Vectorized uint8 fast path: (S, H, W) uint8 -> (S, H+6, W, 1)
    float32 in [-1, 1]; bit-exact with event_transform's composed chain
    when noise is disabled. With noise the add happens post-normalize
    (2s*u on the [-1,1] scale vs the chain's pre-normalize (x+s*u-0.5)/0.5)
    — identical real-number algebra, equal only up to one f32 ulp."""
    s, h, w = imgs.shape
    out = np.empty((s, h + 6, w), np.float32)
    out[:, :3] = -1.0
    out[:, h + 3:] = -1.0
    out[:, 3:h + 3] = _U8_LUT[imgs]
    if rng is not None and noise_scale:
        out += (2.0 * noise_scale) * rng.random(out.shape, np.float32)
    return out[..., None]


class ImageEventsDataset:
    """Index-addressable event dataset over the per-sensor directory tree.

    ``cache_decoded`` (config key ``load_in_mem``; from the second epoch on
    no PNG is decoded again): keep decoded uint8 images in RAM after first
    use. Guarded by an estimate
    against ``IEAGAN_CACHE_BYTES`` (default 16 GiB) — oversized datasets
    silently fall back to per-item decode."""

    def __init__(self, path: str, noise_scale: float = 4e-3,
                 seed: int | None = None, cache_decoded: bool = True,
                 raw_uint8: bool = False):
        # raw_uint8: skip the host transform; items are (S, H, W) uint8
        # stacks for on-device transformation (ops/image_norm.py::
        # device_event_transform) — 4x less host->device traffic
        self.raw_uint8 = raw_uint8
        self.path = path
        self.subdirs: Sequence[str] = sorted(os.listdir(path))
        if not self.subdirs:
            raise ValueError(f"no sensor subdirectories under {path}")
        self.filenames: Sequence[str] = sorted(
            os.listdir(os.path.join(path, self.subdirs[0])))
        self.noise_scale = noise_scale
        self.seed = seed
        self._cache: dict | None = None
        if cache_decoded and Image is not None and self.filenames:
            probe = self.load_image(self.subdirs[0], self.filenames[0])
            total = probe.nbytes * len(self.subdirs) * len(self.filenames)
            budget = int(os.environ.get("IEAGAN_CACHE_BYTES", 16 << 30))
            if total <= budget:
                self._cache = {(self.subdirs[0], self.filenames[0]): probe}

    def __len__(self):
        return len(self.filenames)

    @property
    def n_sensors(self):
        return len(self.subdirs)

    def load_image(self, subdir: str, filename: str) -> np.ndarray:
        cache = self._cache if hasattr(self, "_cache") else None
        if cache is not None:
            img = cache.get((subdir, filename))
            if img is not None:
                return img
        fp = os.path.join(self.path, subdir, filename)
        if Image is None:
            raise RuntimeError("PIL is required to load image datasets")
        with Image.open(fp) as im:
            img = np.asarray(im.convert("L"))
        if cache is not None:
            cache[(subdir, filename)] = img
        return img

    def __getitem__(self, event_idx: int):
        """-> (images (n_sensors, H, W, 1) float32, labels (n_sensors,) int32)."""
        raw = [self.load_image(sub, self.filenames[event_idx])
               for sub in self.subdirs]
        labels = np.arange(self.n_sensors, dtype=np.int32)
        if getattr(self, "raw_uint8", False):
            return np.stack([np.asarray(r, np.uint8) for r in raw]), labels
        rng = None
        if self.noise_scale:
            seed = (self.seed, event_idx) if self.seed is not None else None
            rng = np.random.default_rng(seed)
        if all(r.dtype == np.uint8 and r.ndim == 2 for r in raw):
            # same noise stream as the per-image loop: one (S,H+6,W) draw
            # consumes the generator in identical row-major order
            imgs = event_transform_stack(np.stack(raw), rng, self.noise_scale)
        else:
            imgs = np.stack([event_transform(r, rng, self.noise_scale)
                             for r in raw])
        return imgs, labels


def load_dataset(data_path: str, num_workers: int = 8, shuffle: bool = True,
                 seed: int | None = None, events_per_batch: int = 1,
                 raw_uint8: bool = False, process_index: int = 0, process_count: int = 1):
    """Reference-parity entry point (utils/dataloader.py:56-81) returning an
    iterable of (images, labels) event batches; set the loader's ``device``
    to have them copied there in its producer thread. With several processes
    each loads its share of every batch (``EventLoader``)."""
    from ieagan_torch.data.pipeline import EventLoader
    ds = ImageEventsDataset(data_path, seed=seed, raw_uint8=raw_uint8)
    return EventLoader(ds, num_workers=num_workers, shuffle=shuffle, seed=seed,
                       events_per_batch=events_per_batch, process_index=process_index,
                       process_count=process_count)
