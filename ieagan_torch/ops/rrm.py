"""Relational Reasoning Module (twin of ``ieagan_tpu/ops/rrm.py``): a pre-LN
transformer over the intra-event (sensor) axis.

  * MultiheadSelfAttention: packed qkv projection chunked per head as
    ``(b, s, heads, 3*hd)`` (``ieagan_tpu/ops/rrm.py:42-47``), 1/sqrt(hd)
    scaling, softmax over the event axis;
  * EncoderBlock: x + attn(LN(x)); x + mlp(LN(x)) (dropout is 0 in all
    configs and omitted);
  * RelationalReasoning: encoder blocks + a final LayerNorm.

``linear(in, out)`` builds the projections: plain Linear in G's proxy RRM
(reference: model.py:305-313). ``site`` names the attention's span
(``ops/attention.py::attention_site``).
"""

from __future__ import annotations

from typing import Callable

import torch.nn as nn
import torch.nn.functional as F

from ieagan_torch.ops.attention import attention_site, dot_softmax_attention
from ieagan_torch.ops.norm import LayerNorm


class MultiheadSelfAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, linear: Callable,
                 fused: bool = False, site: str | None = None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.fused = fused
        self.site = site
        self.qkv_proj = linear(embed_dim, 3 * embed_dim)
        self.o_proj = linear(embed_dim, embed_dim)

    def forward(self, x):
        b, s, _ = x.shape
        head_dim = self.embed_dim // self.num_heads
        # the heads this rank computes: all, or its own when qkv_proj and
        # o_proj are a split pair (parallel/tensor.py)
        qkv = self.qkv_proj(x).reshape(b, s, -1, 3 * head_dim)
        q, k, v = qkv.transpose(1, 2).chunk(3, dim=-1)  # (b, heads, s, hd) each
        with attention_site(self.site):
            values = dot_softmax_attention(q, k, v, scale=1.0 / float(head_dim) ** 0.5,
                                           fused=self.fused)
        return self.o_proj(values.transpose(1, 2).reshape(b, s, -1))


class EncoderBlock(nn.Module):
    def __init__(self, input_dim: int, num_heads: int, dim_feedforward: int,
                 linear: Callable, fused: bool = False, site: str | None = None):
        super().__init__()
        self.self_attn = MultiheadSelfAttention(input_dim, num_heads, linear, fused, site)
        self.norm1 = LayerNorm(input_dim)
        self.norm2 = LayerNorm(input_dim)
        self.linear1 = linear(input_dim, dim_feedforward)
        self.linear2 = linear(dim_feedforward, input_dim)

    def forward(self, x):
        x = x + self.self_attn(self.norm1(x))
        return x + self.linear2(F.relu(self.linear1(self.norm2(x))))


class RelationalReasoning(nn.Module):
    """Encoder blocks ``layers_<i>`` + final LayerNorm ``norm``
    (reference: RRM.py:112-125)."""

    def __init__(self, num_layers: int, input_dim: int, num_heads: int,
                 dim_feedforward: int, linear: Callable, fused: bool = False,
                 site: str | None = None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layers_{i}", EncoderBlock(
                input_dim, num_heads, dim_feedforward, linear, fused, site))
        self.norm = LayerNorm(input_dim)

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"layers_{i}")(x)
        return self.norm(x)
