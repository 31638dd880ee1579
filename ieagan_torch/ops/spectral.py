"""Spectral normalization with ``u``/``sv`` buffers (twin of ``ieagan_tpu/ops/spectral.py``).

Semantics of the reference SN (reference: layers.py:89-165), as the JAX
package keeps them:
  * per-layer left singular vector(s) ``u`` of shape (num_svs, out);
  * ``num_itrs`` power-iteration step(s) on every forward call, eval included
    (an eval call without grad reuses the W/σ of the last call whose ``weight``
    and ``u`` it still sees: ``_SpectralNorm.normalized_weight``);
  * Gram-Schmidt across the ``num_svs`` tracked singular values;
  * ``u`` and the logged ``sv`` are written back only in train mode, and
    never by an activation recompute (``ops/remat.py``);
  * ``sv = v Wᵀ uᵀ`` carries gradient through W (u and v are constants).

Weights are in PyTorch layout: linear ``(out, in)``, conv ``(O, I, kh, kw)``.
The conv's flattened fan-in order differs from the JAX package's
``(kh, kw, I)``, but the singular values and ``u`` (which lives in the output
space) do not depend on it. Parameters are allocated empty; the owner calls
``reset_parameters(generator)`` or loads a state dict.

A layer split over the mesh's model axis (``parallel/tensor.py``) holds a
block of rows or columns of the (out, fan-in) matrix and gives the power
iteration its own products with W (``sn_products``), which run over the
axis; ``u`` and ``sv`` stay whole and equal on every rank.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ieagan_torch.core.spans import span
from ieagan_torch.ops.remat import recompute_u


def _l2normalize(v, eps: float):
    # F.normalize semantics: v / max(||v||, eps)  (reference: layers.py:97,103)
    return v / torch.clamp(torch.linalg.vector_norm(v), min=eps)


class WholeProducts:
    """The power iteration's three products with W, for a W the process
    holds whole."""

    @staticmethod
    def v(u, w):
        return u @ w

    @staticmethod
    def u(v, w):
        return v @ w.T

    @staticmethod
    def sigma(vs, w_mat, us):
        return torch.einsum("sk,ok,so->s", vs, w_mat, us)


def power_iteration(w_mat, us, n_itrs: int, eps: float, products=WholeProducts):
    """Power iteration(s) with Gram-Schmidt over tracked singular vectors.

    w_mat: (out, k); us: (num_svs, out). Returns ``(svs, new_us)``: the
    (num_svs,) singular-value estimates, with gradient through ``w_mat``, and
    the updated (num_svs, out) vectors, without gradient. ``products`` are
    the products with W (``WholeProducts``, or a split layer's).
    """
    w = w_mat.detach()
    vs = []
    for _ in range(n_itrs):
        new_us, vs = [], []
        for i in range(us.shape[0]):
            v = products.v(us[i], w)
            for v_prev in vs:  # Gram-Schmidt (reference: layers.py:82-85)
                v = v - (v @ v_prev) * v_prev / torch.clamp(v_prev @ v_prev, min=eps)
            v = _l2normalize(v, eps)
            u = products.u(v, w)
            for u_prev in new_us:
                u = u - (u @ u_prev) * u_prev / torch.clamp(u_prev @ u_prev, min=eps)
            u = _l2normalize(u, eps)
            vs.append(v)
            new_us.append(u)
        us = torch.stack(new_us)
    vs = torch.stack(vs).detach()
    us = us.detach()
    return products.sigma(vs, w_mat, us), us


class _SpectralNorm(nn.Module):
    """Buffers and power iteration shared by the SN layers."""

    sn_products = WholeProducts

    def _init_sn(self, out_features: int, num_svs: int, num_itrs: int, eps: float):
        self.num_itrs = num_itrs
        self.eps = eps
        self.register_buffer("u", torch.empty(num_svs, out_features))
        self.register_buffer("sv", torch.empty(num_svs))
        # (key, the tensors it was read from, W/σ) of the last eval call
        self._sn_cache = None

    def _reset_sn(self, generator):
        with torch.no_grad():
            self.u.normal_(generator=generator)
            self.sv.fill_(1.0)

    def train(self, mode: bool = True):
        if mode:
            self._sn_cache = None
        return super().train(mode)

    def _apply(self, *args, **kwargs):
        self._sn_cache = None
        return super()._apply(*args, **kwargs)

    def _sn_key(self):
        """What W/σ depends on: the storage address, in-place version and
        dtype of ``weight`` and ``u``, and the device and shape of
        ``weight``; None where one of them is an inference tensor, whose
        in-place writes no version counts. A write through ``.data`` is not
        counted either: write under ``no_grad``."""
        w, u = self.weight, self.u
        if w.is_inference() or u.is_inference():
            return None
        return (w.data_ptr(), w._version, w.dtype, w.device, w.shape,
                u.data_ptr(), u._version, u.dtype)

    def normalized_weight(self):
        """W / σ(W). In a recompute segment's backward (``ops/remat.py``)
        the power iteration starts from the ``u`` of the segment's entry and
        writes nothing back. In eval with grad off (``no_grad``,
        ``inference_mode``) it writes nothing either, so its result is kept
        and returned again while ``_sn_key`` reads the same: the same
        tensor, bit for bit. The entry holds the tensors it was read from,
        so their storage, and its address, stays theirs until the entry is
        replaced or dropped (``train()``, ``.to()``). Traced, the span
        ``ieagan.sn`` holds the power iteration, ``ieagan.sn.cached`` a
        reuse."""
        u0 = recompute_u(self)
        key = None
        if not self.training and u0 is None and not torch.is_grad_enabled():
            key = self._sn_key()
            if key is not None and self._sn_cache is not None and self._sn_cache[0] == key:
                with span("ieagan.sn.cached"):
                    return self._sn_cache[2]
        with span("ieagan.sn"):
            w_mat = self.weight.reshape(self.weight.shape[0], -1)
            svs, new_us = power_iteration(w_mat, self.u if u0 is None else u0, self.num_itrs,
                                          self.eps, self.sn_products)
            if self.training and u0 is None:
                with torch.no_grad():
                    self.u.copy_(new_us)
                    self.sv.copy_(svs)
            out = (w_mat / svs[0]).reshape(self.weight.shape)
            if key is not None:
                self._sn_cache = (key, (self.weight.detach(), self.u.detach()), out)
            return out


class SNLinear(_SpectralNorm):
    """Linear layer with spectral norm (reference: SNLinear, layers.py:210-224)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 num_svs: int = 1, num_itrs: int = 1, eps: float = 1e-12):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None
        self._init_sn(out_features, num_svs, num_itrs, eps)

    def reset_parameters(self, generator=None):
        nn.init.orthogonal_(self.weight, generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)
        self._reset_sn(generator)

    def forward(self, x):
        return F.linear(x, self.normalized_weight().to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype))


class SNConv2d(_SpectralNorm):
    """2-D conv (NCHW, stride 1, SAME padding) with spectral norm
    (reference: SNConv2d, layers.py:169-206)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 bias: bool = True, num_svs: int = 1, num_itrs: int = 1,
                 eps: float = 1e-12):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError("SAME padding needs an odd kernel size")
        self.padding = kernel_size // 2
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        self._init_sn(out_channels, num_svs, num_itrs, eps)

    def reset_parameters(self, generator=None):
        nn.init.orthogonal_(self.weight, generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)
        self._reset_sn(generator)

    def forward(self, x):
        return F.conv2d(x, self.normalized_weight().to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype),
                        padding=self.padding)


class SNEmbedding(_SpectralNorm):
    """Embedding with spectral norm (reference: SNEmbedding, layers.py:230-259).
    As the reference does, the (num_embeddings, features) matrix itself is
    normalized, so ``u`` has length num_embeddings (the JAX package's
    ``SNEmbed``, ``ieagan_tpu/ops/spectral.py:160-181``)."""

    def __init__(self, num_embeddings: int, features: int, num_svs: int = 1,
                 num_itrs: int = 1, eps: float = 1e-12):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings, features))
        self._init_sn(num_embeddings, num_svs, num_itrs, eps)

    def reset_parameters(self, generator=None):
        nn.init.orthogonal_(self.weight, generator=generator)
        self._reset_sn(generator)

    def forward(self, y):
        return F.embedding(y, self.normalized_weight())


class Linear(nn.Module):
    """Plain linear, call-compatible with SNLinear (reference: G's RRM
    internals use nn.Linear, model.py:305-313)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def reset_parameters(self, generator=None):
        nn.init.orthogonal_(self.weight, generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype))


class Conv2d(nn.Module):
    """Plain 2-D conv (NCHW, stride 1, SAME padding), call-compatible with
    SNConv2d: the twin of flax ``nn.Conv`` as the JAX generator builds it for
    ``G_param != "SN"`` (``ieagan_tpu/models/generator.py:151-157``) and as
    ILA builds its projections. Initialized as flax initializes it: LeCun
    normal (truncated at two standard deviations), zero bias."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 bias: bool = True):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError("SAME padding needs an odd kernel size")
        self.padding = kernel_size // 2
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def reset_parameters(self, generator=None):
        # flax's lecun_normal: std sqrt(1 / fan_in), corrected for the truncation
        std = (1.0 / self.weight[0].numel()) ** 0.5 / 0.87962566103423978
        nn.init.trunc_normal_(self.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        return F.conv2d(x, self.weight.to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype),
                        padding=self.padding)


class Embedding(nn.Module):
    """Plain embedding with orthogonal init (reference: G's shared embedding,
    model.py:263)."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings, features))

    def reset_parameters(self, generator=None):
        nn.init.orthogonal_(self.weight, generator=generator)

    def forward(self, y):
        return F.embedding(y, self.weight)
