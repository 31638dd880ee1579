"""Attention over the sequence axis (twin of ``ieagan_tpu/ops/attention.py:32-44``)."""

from __future__ import annotations

import torch

from ieagan_torch.kernels.flash_attention import attention_fwd


def dot_softmax_attention(q, k, v, scale: float = 1.0, fused: bool = False):
    """softmax(scale * q kᵀ) v over the last-but-one (sequence) axis.

    q: (..., Lq, dk), k: (..., Lkv, dk), v: (..., Lkv, dv) -> (..., Lq, dv).
    Softmax statistics in float32. ``fused`` takes the fused attention
    kernel (B1) for CUDA tensors and its plain version for CPU tensors, as
    the JAX package takes its Pallas kernel under ``use_pallas_attention``;
    otherwise the plain composition runs on any device.
    """
    if fused:
        lead = q.shape[:-2]
        lq, dk = q.shape[-2:]
        lkv, dv = v.shape[-2:]
        o, _ = attention_fwd(q.reshape(-1, lq, dk).contiguous(),
                             k.reshape(-1, lkv, dk).contiguous(),
                             v.reshape(-1, lkv, dv).contiguous(), scale)
        return o.reshape(*lead, lq, dv)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype), v).to(v.dtype)
