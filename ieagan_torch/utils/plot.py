"""Similarity heatmaps and image grids (twin of ``ieagan_tpu/utils/plot.py``;
reference: utils/plot.py:13-70).

``plot_sim_heatmap`` renders the cosine-similarity matrix of the class
proxies / G embeddings, the training-time diagnostic saved alongside samples
(reference: train.py:196-229); it needs matplotlib, and the driver catches
its failure as the JAX driver does. ``plot_imgs`` draws with matplotlib when
it is installed; without it (the GPU machine has none) it writes the same
images as one plain grayscale grid with PIL and says so, so a sample sheet is
never skipped.
"""

from __future__ import annotations

import numpy as np


def cosine_similarity_matrix(emb: np.ndarray) -> np.ndarray:
    e = np.asarray(emb, np.float64)
    e = e / np.maximum(np.linalg.norm(e, axis=-1, keepdims=True), 1e-12)
    return e @ e.T


def plot_sim_heatmap(emb: np.ndarray, path: str, labels=None,
                     title: str = "cosine similarity"):
    """Save a cosine-similarity heatmap of (N, D) embeddings."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    sim = cosine_similarity_matrix(emb)
    fig, ax = plt.subplots(figsize=(8, 7))
    im = ax.imshow(sim, cmap="coolwarm", vmin=-1, vmax=1)
    fig.colorbar(im, ax=ax)
    ax.set_title(title)
    if labels is not None:
        ax.set_xticks(range(len(labels)))
        ax.set_yticks(range(len(labels)))
        ax.set_xticklabels(labels, fontsize=5, rotation=90)
        ax.set_yticklabels(labels, fontsize=5)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return sim


def tile(imgs: np.ndarray, ncol: int) -> np.ndarray:
    """(N, H, W) images -> one (nrow*H, ncol*W) uint8 grid, row-major, each
    image truncated to uint8 and empty cells zero (the JAX driver's
    ``save_event_grid`` layout)."""
    n, h, w = imgs.shape
    nrow = (n + ncol - 1) // ncol
    grid = np.zeros((nrow * h, ncol * w), np.uint8)
    for i in range(n):
        r, c = divmod(i, ncol)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = imgs[i].astype(np.uint8)
    return grid


def save_gray(grid: np.ndarray, path):
    """Write a (H, W) uint8 image with PIL; the format follows the suffix."""
    from PIL import Image
    Image.fromarray(grid).save(path)


def plot_imgs(imgs: np.ndarray, path: str, ncol: int | None = None):
    """Grid plot of (N, H, W) images (reference: utils/plot.py:13-26)."""
    n = imgs.shape[0]
    ncol = ncol or int(np.ceil(np.sqrt(n)))
    try:
        import matplotlib
    except ImportError:
        print(f"matplotlib unavailable: {path} written as a plain grayscale grid")
        save_gray(tile(np.clip(imgs, 0, 255), ncol), path)
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    nrow = (n + ncol - 1) // ncol
    fig, axes = plt.subplots(nrow, ncol, figsize=(2 * ncol, 1.2 * nrow))
    axes = np.atleast_1d(axes).ravel()
    for i, ax in enumerate(axes):
        ax.axis("off")
        if i < n:
            ax.imshow(imgs[i], cmap="gray")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
