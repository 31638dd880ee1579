"""clean-FID resize to 299x299 (twin of ``ieagan_tpu/eval/resize.py``).

The metric is defined by PIL's mode-"F" resize of the single channel,
replicated to 3 channels (reference: mycleanfid/fid.py:151-196, 690-697).
``pil_resize_single_channel`` is a copy of that host path. The device path,
``resize_single_channel``, is ``F.interpolate`` with ``antialias=True``,
PyTorch's port of PIL's filters ("bilinear" is PIL's triangle filter,
"bicubic" its cubic), as ``jax_resize_single_channel`` is JAX's.

Layout: the port hands Inception NCHW batches, (B, 3, 299, 299); the JAX
package's contract is (B, 299, 299, 3). Both resizes here return NCHW.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None


def pil_resize_single_channel(x: np.ndarray, size=(299, 299),
                              interp: str = "bilinear") -> np.ndarray:
    """(H, W) float -> (299, 299) float32 via PIL mode-F resampling."""
    img = Image.fromarray(np.asarray(x, np.float32), mode="F")
    resample = Image.BICUBIC if interp == "bicubic" else Image.BILINEAR
    img = img.resize(size, resample=resample)
    return np.asarray(img, np.float32)


def pil_resize_batch(batch: np.ndarray, size=(299, 299),
                     interp: str = "bilinear") -> np.ndarray:
    """(B, H, W) -> (B, 3, 299, 299) float32, channel-replicated."""
    out = np.empty((batch.shape[0], 3, size[1], size[0]), np.float32)
    for i in range(batch.shape[0]):
        out[i] = pil_resize_single_channel(batch[i], size, interp)[None]
    return out


def resize_single_channel(batch: torch.Tensor, size=(299, 299),
                          interp: str = "bilinear") -> torch.Tensor:
    """(B, H, W) -> (B, 3, 299, 299) on the batch's device: the antialiased
    resize PyTorch ports from PIL, replicated to 3 channels."""
    mode = "bicubic" if interp == "bicubic" else "bilinear"
    out = F.interpolate(batch[:, None].float(), size=(size[1], size[0]), mode=mode,
                        align_corners=False, antialias=True)
    return out.expand(-1, 3, -1, -1).contiguous()
