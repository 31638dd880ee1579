"""Modified orthogonal regularization on ``.grad`` (twin of
``ieagan_tpu/train/ortho.py``; reference: utils/__init__.py:843-859).

After backward and before the optimizer, for every weight W of two or more
dimensions, viewed as the (out, fan_in) matrix of the JAX package's kernel:

    grad += strength * 2 * ((W Wᵀ) ⊙ (1 - I)) W

For a conv or linear weight that matrix is ``weight.reshape(out, -1)`` (the
Gram matrix does not depend on the fan-in order). For an embedding the JAX
kernel's output axis is ``features``, so the matrix is ``weight.T``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ieagan_torch.ops.spectral import Embedding, SNEmbedding


def _ortho_grad(w_mat):
    gram = w_mat @ w_mat.T
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
            if isinstance(module, (Embedding, SNEmbedding)):
                term = _ortho_grad(p.T).T
            else:
                term = _ortho_grad(p.reshape(p.shape[0], -1)).reshape(p.shape)
            if p.grad is None:
                p.grad = strength * term
            else:
                p.grad.add_(term, alpha=strength)
