"""Spectral normalization with ``u``/``sv`` buffers (twin of ``ieagan_tpu/ops/spectral.py``).

Semantics of the reference SN (reference: layers.py:89-165), as the JAX
package keeps them:
  * per-layer left singular vector(s) ``u`` of shape (num_svs, out);
  * ``num_itrs`` power-iteration step(s) on every forward call, eval included;
  * Gram-Schmidt across the ``num_svs`` tracked singular values;
  * ``u`` and the logged ``sv`` are written back only in train mode;
  * ``sv = v Wᵀ uᵀ`` carries gradient through W (u and v are constants).

Weights are in PyTorch layout: linear ``(out, in)``, conv ``(O, I, kh, kw)``.
The conv's flattened fan-in order differs from the JAX package's
``(kh, kw, I)``, but the singular values and ``u`` (which lives in the output
space) do not depend on it. Parameters are allocated empty; the owner calls
``reset_parameters(generator)`` or loads a state dict.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def _l2normalize(v, eps: float):
    # F.normalize semantics: v / max(||v||, eps)  (reference: layers.py:97,103)
    return v / torch.clamp(torch.linalg.vector_norm(v), min=eps)


def power_iteration(w_mat, us, n_itrs: int, eps: float):
    """Power iteration(s) with Gram-Schmidt over tracked singular vectors.

    w_mat: (out, k); us: (num_svs, out). Returns ``(svs, new_us)``: the
    (num_svs,) singular-value estimates, with gradient through ``w_mat``, and
    the updated (num_svs, out) vectors, without gradient.
    """
    w = w_mat.detach()
    vs = []
    for _ in range(n_itrs):
        new_us, vs = [], []
        for i in range(us.shape[0]):
            v = us[i] @ w
            for v_prev in vs:  # Gram-Schmidt (reference: layers.py:82-85)
                v = v - (v @ v_prev) * v_prev / torch.clamp(v_prev @ v_prev, min=eps)
            v = _l2normalize(v, eps)
            u = v @ w.T
            for u_prev in new_us:
                u = u - (u @ u_prev) * u_prev / torch.clamp(u_prev @ u_prev, min=eps)
            u = _l2normalize(u, eps)
            vs.append(v)
            new_us.append(u)
        us = torch.stack(new_us)
    vs = torch.stack(vs).detach()
    us = us.detach()
    svs = torch.einsum("sk,ok,so->s", vs, w_mat, us)
    return svs, us


class _SpectralNorm(nn.Module):
    """Buffers and power iteration shared by the SN layers."""

    def _init_sn(self, out_features: int, num_svs: int, num_itrs: int, eps: float):
        self.num_itrs = num_itrs
        self.eps = eps
        self.register_buffer("u", torch.empty(num_svs, out_features))
        self.register_buffer("sv", torch.empty(num_svs))

    def _reset_sn(self, generator):
        with torch.no_grad():
            self.u.normal_(generator=generator)
            self.sv.fill_(1.0)

    def normalized_weight(self):
        w_mat = self.weight.reshape(self.weight.shape[0], -1)
        svs, new_us = power_iteration(w_mat, self.u, self.num_itrs, self.eps)
        if self.training:
            with torch.no_grad():
                self.u.copy_(new_us)
                self.sv.copy_(svs)
        return (w_mat / svs[0]).reshape(self.weight.shape)


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
