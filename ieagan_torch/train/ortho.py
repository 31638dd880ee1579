"""Modified orthogonal regularization on ``.grad`` (twin of
``ieagan_tpu/train/ortho.py``; reference: utils/__init__.py:843-859).

After backward and before the optimizer, for every weight W of two or more
dimensions, viewed as the (out, fan_in) matrix of the JAX package's kernel:

    grad += strength * 2 * ((W Wᵀ) ⊙ (1 - I)) W

For a conv or linear weight that matrix is ``weight.reshape(out, -1)`` (the
Gram matrix does not depend on the fan-in order). For an embedding the JAX
kernel's output axis is ``features``, so the matrix is ``weight.T``.

A weight split over the mesh's model axis (``parallel/tensor.py``) holds a
block of the matrix's rows (a column split) or columns (a row split). For
rows, the Gram matrix needs every row: the whole matrix is gathered over the
axis and the block's rows of the term are added. For columns, the Gram
matrix is the sum of the ranks' partial Gram matrices, multiplied by the
block.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ieagan_torch.ops.spectral import Embedding, SNEmbedding
from ieagan_torch.parallel.collectives import model_gather, model_reduce


def _ortho_grad(w_mat, split=None):
    """The term for ``w_mat``, or with ``split = (axis, mesh)`` for this
    rank's block of rows (axis 0) or columns (axis 1) of the whole matrix."""
    axis, mesh = split if split is not None else (None, None)
    if axis == 0:
        whole = model_gather(w_mat, 0, mesh)
        gram = w_mat @ whole.T
        rows = slice(mesh.model_index * w_mat.shape[0], (mesh.model_index + 1) * w_mat.shape[0])
        eye = torch.eye(whole.shape[0], dtype=w_mat.dtype, device=w_mat.device)[rows]
        return 2.0 * ((gram * (1.0 - eye)) @ whole)
    gram = w_mat @ w_mat.T
    if axis == 1:
        gram = model_reduce(gram, mesh)
    gram = gram * (1.0 - torch.eye(gram.shape[0], dtype=w_mat.dtype, device=w_mat.device))
    return 2.0 * (gram @ w_mat)


@torch.no_grad()
def apply_ortho_reg(model: nn.Module, strength: float, blacklist: tuple[str, ...] = ()):
    """Add the orthogonal regularizer's gradient to ``.grad`` of every
    parameter of ``model`` with two or more dimensions whose name does not
    start with a prefix in ``blacklist`` (G's ``shared`` embedding, reference:
    train_fns.py:185-188). A parameter without a gradient gets the term
    alone. No-op for ``strength <= 0``."""
    if strength <= 0.0:
        return
    for module_name, module in model.named_modules():
        for name, p in module.named_parameters(recurse=False):
            full = f"{module_name}.{name}" if module_name else name
            if p.ndim < 2 or full.startswith(blacklist):
                continue
            tp = getattr(module, "tp", None) if name == "weight" else None
            if isinstance(module, (Embedding, SNEmbedding)):
                # the matrix is the weight's transpose: a split of its dim 1 cuts rows
                split = None if tp is None else (1 - tp.dim, tp.mesh)
                term = _ortho_grad(p.T, split).T
            else:
                split = None if tp is None else (tp.dim, tp.mesh)
                term = _ortho_grad(p.reshape(p.shape[0], -1), split).reshape(p.shape)
            if p.grad is None:
                p.grad = strength * term
            else:
                p.grad.add_(term, alpha=strength)
