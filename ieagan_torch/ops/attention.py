"""Attention over the sequence axis and the image attentions (twin of
``ieagan_tpu/ops/attention.py``; reference: layers.py:262-501): SA-GAN
self-attention, CBAM channel and spatial attention, and ILA linear attention.
CBAM and ILA have no fused kernel in either package."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ieagan_torch.kernels.flash_attention import FlashAttention
from ieagan_torch.ops.spectral import Conv2d, SNConv2d


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
                 eps: float = 1e-12, fused: bool = False, conv=None):
        super().__init__()
        self.ch = ch
        self.fused = fused
        if conv is None:  # ``conv(cin, cout, ksize, bias=...)`` builds the 1x1 convs
            conv = lambda cin, cout, ksize, bias: SNConv2d(
                cin, cout, ksize, bias=bias, num_svs=num_svs, num_itrs=num_itrs, eps=eps)
        self.theta = conv(ch, ch // 8, 1, bias=False)
        self.phi = conv(ch, ch // 8, 1, bias=False)
        self.g = conv(ch, ch // 2, 1, bias=False)
        self.o = conv(ch // 2, ch, 1, bias=False)
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


class CBAMAttention(nn.Module):
    """CBAM (reference: layers.py:395-434): a channel gate
    ``sigmoid(fc2(relu(fc1(mean))) + fc2(relu(fc1(max))))`` over the spatial
    mean and max, then a spatial gate ``sigmoid(conv_after_concat([mean;
    max]))`` over the channel mean and max. ``conv(cin, cout, ksize)`` builds
    the convs, with bias (SN in D and in G with ``G_param="SN"``); ``fc1`` and
    ``fc2`` run twice per forward, so their ``u`` advances twice in train
    mode, as in the JAX package."""

    def __init__(self, ch: int, conv, reduction: int = 8, attention_kernel_size: int = 3):
        super().__init__()
        self.fc1 = conv(ch, ch // reduction, 1)
        self.fc2 = conv(ch // reduction, ch, 1)
        self.conv_after_concat = conv(2, 1, attention_kernel_size)

    def forward(self, x):
        avg = self.fc2(F.relu(self.fc1(x.mean(dim=(2, 3), keepdim=True))))
        mx = self.fc2(F.relu(self.fc1(x.amax(dim=(2, 3), keepdim=True))))
        x = x * torch.sigmoid(avg + mx)
        sp = torch.cat([x.mean(dim=1, keepdim=True), x.amax(dim=1, keepdim=True)], dim=1)
        return x * torch.sigmoid(self.conv_after_concat(sp))


class ILA(nn.Module):
    """Image linear attention (reference: layers.py:437-501): plain 1x1 convs
    with bias ``to_q``, ``to_k``, ``to_v``, ``to_out``; ``heads`` heads of
    ``key_dim`` / ``value_dim``; q and k scaled by ``key_dim ** -0.25``, k
    softmaxed over positions and q over its key dimension, both in f32; out =
    q · (k · vᵀ) per head. Channels are ordered (head, dim), as the JAX
    package's NHWC reshape orders them."""

    def __init__(self, ch: int, key_dim: int = 32, value_dim: int = 64, heads: int = 8,
                 norm_queries: bool = True):
        super().__init__()
        self.key_dim, self.value_dim, self.heads = key_dim, value_dim, heads
        self.norm_queries = norm_queries
        self.to_q = Conv2d(ch, key_dim * heads, 1)
        self.to_k = Conv2d(ch, key_dim * heads, 1)
        self.to_v = Conv2d(ch, value_dim * heads, 1)
        self.to_out = Conv2d(value_dim * heads, ch, 1)

    def forward(self, x):
        b, _, h, w = x.shape
        scale = self.key_dim ** -0.25
        q = self.to_q(x).reshape(b, self.heads, self.key_dim, h * w) * scale
        k = self.to_k(x).reshape(b, self.heads, self.key_dim, h * w) * scale
        v = self.to_v(x).reshape(b, self.heads, self.value_dim, h * w)
        k = torch.softmax(k.float(), dim=-1).to(x.dtype)
        if self.norm_queries:
            q = torch.softmax(q.float(), dim=-2).to(x.dtype)
        context = torch.einsum("bhdn,bhen->bhde", k, v)
        out = torch.einsum("bhdn,bhde->bhen", q, context)
        return self.to_out(out.reshape(b, self.heads * self.value_dim, h, w))
