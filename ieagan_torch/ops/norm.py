"""Batch norm family and LayerNorm (twin of ``ieagan_tpu/ops/norm.py``).

Reference semantics (reference: layers.py:505-742), NCHW here:
  * train mode: batch moments over (N, H, W) in f32; running stats updated as
    ``running = (1-m)*running + m*batch`` with m = 0.1 and the unbiased batch
    variance; inside ``parallel/collectives.py::global_batch(mesh)`` the
    moments span the global batch of every rank of the mesh, as the JAX
    package's do under its sharded jit (``ieagan_tpu/ops/norm.py:15-18``);
  * eval mode: running stats, divided by the standing-stats counter when
    standing stats are in use (myBN, layers.py:547-599);
  * ccbn (layers.py:622-694): gain = 1 + Linear(y), bias = Linear(y), per
    sample, after the unparameterized normalization, which is batch norm
    (``norm_style="bn"``) or, without running stats, instance norm
    (``"in"``), group norm (``"gn*"``, ``"grp_<groups>"``, ``"ch_<channels
    per group>"``) or none (``"nonorm"``).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from ieagan_torch.ops.remat import recomputing
from ieagan_torch.parallel.collectives import all_reduce_sum, batch_mesh


def _moments(xf):
    """Per-channel ``(mean, biased var, count)`` of NCHW ``xf`` over (N, H,
    W), over every rank's batch inside ``parallel/collectives.py::global_batch``:
    one all-reduce of the per-channel ``Σx`` and ``Σx²`` a layer, then
    ``E[x²] - E[x]²`` in f32 as one process computes it."""
    n = xf.numel() // xf.shape[1]
    mesh = batch_mesh()
    if mesh is None:
        mean = xf.mean(dim=(0, 2, 3))
        return mean, (xf * xf).mean(dim=(0, 2, 3)) - mean * mean, n
    # every rank holds the same batch shape, so the global count is exact
    sums = all_reduce_sum(torch.stack([xf.sum(dim=(0, 2, 3)),
                                       (xf * xf).sum(dim=(0, 2, 3))]), mesh)
    n = n * mesh.n_data
    mean = sums[0] / n
    return mean, sums[1] / n - mean * mean, n


class _BatchStats(nn.Module):
    """Running (or standing) statistics and the normalization that uses them."""

    def _init_stats(self, num_features: int, eps: float, momentum: float):
        self.eps = eps
        self.momentum = momentum
        self.register_buffer("mean", torch.empty(num_features))
        self.register_buffer("var", torch.empty(num_features))
        self.register_buffer("accumulation_counter", torch.empty(()))

    def _reset_stats(self):
        with torch.no_grad():
            self.mean.zero_()
            self.var.fill_(1.0)
            self.accumulation_counter.zero_()

    def _scale_shift(self, x, accumulate_standing: bool):
        """Per-channel ``(inv_std, mean)`` in f32 for normalizing ``x``,
        updating the running or standing stats in train mode (but not in an
        activation recompute)."""
        if self.training:
            mean, var, n = _moments(x.float())
            with torch.no_grad():
                if recomputing():
                    pass  # the segment's forward updated them (ops/remat.py)
                elif accumulate_standing:
                    self.mean.add_(mean)
                    self.var.add_(var)
                    self.accumulation_counter.add_(1.0)
                else:
                    unbiased = var * (n / max(n - 1, 1))
                    self.mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                    self.var.mul_(1 - self.momentum).add_(self.momentum * unbiased)
        else:
            denom = (torch.clamp(self.accumulation_counter, min=1.0)
                     if accumulate_standing else 1.0)
            mean = self.mean / denom
            var = self.var / denom
        return 1.0 / torch.sqrt(var + self.eps), mean

    def _affine(self, x, inv, mean, gain, bias):
        """``(x - mean) * inv * gain + bias`` as one fused multiply-add;
        gain and bias are (C,) or per sample (N, C)."""
        scale = (gain * inv).reshape(-1, x.shape[1], 1, 1)
        shift = bias.reshape(-1, x.shape[1], 1, 1) - mean[:, None, None] * scale
        return torch.addcmul(shift, x.float(), scale).to(x.dtype)


def group_norm(x, norm_style: str, eps: float = 1e-5):
    """Unparameterized group norm over NCHW ``x`` in f32, groups parsed from
    the style as the reference does (layers.py:603-614): ``ch_<n>`` takes n
    channels per group, ``grp_<n>`` n groups, anything else 16 groups."""
    n, c = x.shape[:2]
    if "ch" in norm_style:
        groups = max(c // int(norm_style.split("_")[-1]), 1)
    elif "grp" in norm_style:
        groups = int(norm_style.split("_")[-1])
    else:
        groups = 16
    xg = x.float().reshape(n, groups, -1)
    mean = xg.mean(dim=-1, keepdim=True)
    var = torch.square(xg - mean).mean(dim=-1, keepdim=True)
    return ((xg - mean) / torch.sqrt(var + eps)).reshape(x.shape)


class ClassCondBatchNorm(_BatchStats):
    """ccbn: a normalization + per-sample gain/bias from linear maps of the
    conditioning vector. ``linear(in, out)`` builds the maps: a bias-free
    SNLinear in the G_shared configuration (reference: model.py:264-268).
    Only ``norm_style="bn"`` owns running stats (``mean``, ``var``,
    ``accumulation_counter``), as only the JAX package's ``_bn_core``
    creates them."""

    def __init__(self, num_features: int, cond_dim: int, linear: Callable,
                 eps: float = 1e-5, momentum: float = 0.1, norm_style: str = "bn"):
        super().__init__()
        group = norm_style.startswith("gn") or "grp" in norm_style or "ch" in norm_style
        if norm_style not in ("bn", "in", "nonorm") and not group:
            raise NotImplementedError(f"norm_style {norm_style!r}")
        self.norm_style = norm_style
        self.gain = linear(cond_dim, num_features)
        self.bias = linear(cond_dim, num_features)
        if norm_style == "bn":
            self._init_stats(num_features, eps, momentum)
        else:
            self.eps = eps

    def reset_parameters(self, generator=None):
        """Resets the stats; ``gain`` and ``bias`` reset themselves."""
        del generator
        if self.norm_style == "bn":
            self._reset_stats()

    def forward(self, x, y, accumulate_standing: bool = False):
        gain = 1.0 + self.gain(y).float()
        bias = self.bias(y).float()
        if self.norm_style == "bn":
            inv, mean = self._scale_shift(x, accumulate_standing)
            return self._affine(x, inv, mean, gain, bias)
        if self.norm_style == "in":  # per-sample spatial moments (layers.py:674-684)
            xf = x.float()
            mean = xf.mean(dim=(2, 3), keepdim=True)
            var = torch.square(xf - mean).mean(dim=(2, 3), keepdim=True)
            out = (xf - mean) / torch.sqrt(var + self.eps)
        elif self.norm_style == "nonorm":
            out = x.float()
        else:
            out = group_norm(x, self.norm_style, self.eps)
        return (out * gain[:, :, None, None] + bias[:, :, None, None]).to(x.dtype)


class BatchNorm(_BatchStats):
    """Plain BN with learned per-channel gain/bias (reference: layers.bn,
    layers.py:698-742). Used in G's output head."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.gain = nn.Parameter(torch.empty(num_features))
        self.bias = nn.Parameter(torch.empty(num_features))
        self._init_stats(num_features, eps, momentum)

    def reset_parameters(self, generator=None):
        del generator
        nn.init.ones_(self.gain)
        nn.init.zeros_(self.bias)
        self._reset_stats()

    def forward(self, x, accumulate_standing: bool = False):
        inv, mean = self._scale_shift(x, accumulate_standing)
        return self._affine(x, inv, mean, self.gain, self.bias)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis in float32 (reference: RRM.py:94-95)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def reset_parameters(self, generator=None):
        del generator
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias,
                            self.eps).to(x.dtype)
