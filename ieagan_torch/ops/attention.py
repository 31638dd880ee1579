"""Attention over the sequence axis and SA-GAN image attention (twin of
``ieagan_tpu/ops/attention.py``; reference: layers.py:262-300)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ieagan_torch.kernels.flash_attention import FlashAttention
from ieagan_torch.ops.spectral import SNConv2d


def dot_softmax_attention(q, k, v, scale: float = 1.0, fused: bool = False):
    """softmax(scale * q kᵀ) v over the last-but-one (sequence) axis.

    q: (..., Lq, dk), k: (..., Lkv, dk), v: (..., Lkv, dv) -> (..., Lq, dv).
    Softmax statistics in float32. ``fused`` takes the fused attention
    kernels (B1 forward, B2 backward) for CUDA tensors and their plain
    versions for CPU tensors, as the JAX package takes its Pallas kernels
    under ``use_pallas_attention``; otherwise the plain composition runs on
    any device. Both are differentiable.
    """
    if fused:
        lead = q.shape[:-2]
        lq, dk = q.shape[-2:]
        lkv, dv = v.shape[-2:]
        o = FlashAttention.apply(q.reshape(-1, lq, dk).contiguous(),
                                 k.reshape(-1, lkv, dk).contiguous(),
                                 v.reshape(-1, lkv, dv).contiguous(), scale)
        return o.reshape(*lead, lq, dv)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype), v).to(v.dtype)


class SelfAttention2d(nn.Module):
    """SA-GAN self-attention over an NCHW feature map: bias-free SN 1x1 convs
    ``theta``, ``phi``, ``g``, ``o``; ``phi`` and ``g`` max-pooled 2x2;
    softmax over the pooled positions WITHOUT 1/sqrt(d) scaling (reference
    quirk, layers.py:293); residual with the learnable scalar ``gamma``
    (initialized to 0). q, k and v are laid out (B, H*W, C) row-major over
    (h, w), as the JAX package's NHWC reshape gives them."""

    def __init__(self, ch: int, num_svs: int = 1, num_itrs: int = 1,
                 eps: float = 1e-12, fused: bool = False):
        super().__init__()
        self.ch = ch
        self.fused = fused
        conv = lambda cin, cout: SNConv2d(cin, cout, 1, bias=False, num_svs=num_svs,
                                          num_itrs=num_itrs, eps=eps)
        self.theta = conv(ch, ch // 8)
        self.phi = conv(ch, ch // 8)
        self.g = conv(ch, ch // 2)
        self.o = conv(ch // 2, ch)
        self.gamma = nn.Parameter(torch.empty(()))

    def reset_parameters(self, generator=None):
        """Zeros ``gamma``; the convs reset themselves."""
        del generator
        nn.init.zeros_(self.gamma)

    def forward(self, x):
        b, _, h, w = x.shape
        q = self.theta(x).flatten(2).transpose(1, 2)                 # (B, HW, C/8)
        k = F.max_pool2d(self.phi(x), 2).flatten(2).transpose(1, 2)  # (B, HW/4, C/8)
        v = F.max_pool2d(self.g(x), 2).flatten(2).transpose(1, 2)    # (B, HW/4, C/2)
        o = dot_softmax_attention(q, k, v, scale=1.0, fused=self.fused)
        o = self.o(o.transpose(1, 2).reshape(b, self.ch // 2, h, w))
        return self.gamma.to(x.dtype) * o + x
