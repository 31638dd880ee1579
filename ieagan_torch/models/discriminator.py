"""Discriminator: BigGAN-deep stack, RRM over per-image features and the
contrastive (hypersphere) head (twin of ``ieagan_tpu/models/discriminator.py``;
reference: model.py:490-944).

NCHW inside; the public ``forward`` takes (B, H, W, 1) images as the JAX
package does. Forward under the Contra strategy (reference: model.py:902-944):

  h = input_conv(x); DBlocks (SA-GAN attention after the D_attn stage)
  h = sum over (H, W) of relu(h)                     (B, 16ch)
  out = linear0(h)               adversarial score, from pre-RRM features
  proxy = embed[y]               spectrally normalized class embedding
  h = RR_D(h per event)          SN linears, 4 heads   [RRM_embed]
  embed = norm(linear1(h))                             (B, hyper)
  proxy, embed l2-normalized                           [normalize_embed]
  returns (proxy, embed, out)
"""

from __future__ import annotations

import functools
import inspect

import torch
import torch.nn as nn
import torch.nn.functional as F

from ieagan_torch.models.arch import d_arch
from ieagan_torch.models.generator import ACTIVATIONS
from ieagan_torch.ops.attention import SelfAttention2d
from ieagan_torch.ops.norm import LayerNorm
from ieagan_torch.ops.rrm import RelationalReasoning
from ieagan_torch.ops.spectral import SNConv2d, SNEmbedding, SNLinear


class DBlock(nn.Module):
    """BigGAN-deep discriminator bottleneck block (reference: model.py:490-557):
    1x1 -> 3x3 -> 3x3 (pre-activations) -> avgpool -> 1x1, with a
    concat-grown shortcut (the extra out - in channels come from ``conv_sc``
    on the shortcut)."""

    def __init__(self, in_channels: int, out_channels: int, conv, activation,
                 preactivation: bool = True, downsample: bool = False,
                 channel_ratio: int = 4):
        super().__init__()
        hidden = out_channels // channel_ratio
        self.activation = activation
        self.preactivation = preactivation
        self.downsample = downsample
        self.conv1 = conv(in_channels, hidden, 1)
        self.conv2 = conv(hidden, hidden, 3)
        self.conv3 = conv(hidden, hidden, 3)
        self.conv4 = conv(hidden, out_channels, 1)
        if in_channels != out_channels:
            self.conv_sc = conv(in_channels, out_channels - in_channels, 1)

    def forward(self, x):
        act = self.activation
        h = F.relu(x) if self.preactivation else x
        h = self.conv1(h)
        h = self.conv2(act(h))
        h = self.conv3(act(h))
        h = act(h)
        sc = x
        if self.downsample:
            h = F.avg_pool2d(h, 2)
            sc = F.avg_pool2d(sc, 2)
        h = self.conv4(h)
        if hasattr(self, "conv_sc"):
            sc = torch.cat([sc, self.conv_sc(sc)], dim=1)
        return h + sc


class Discriminator(nn.Module):
    """The port's Discriminator; build with ``Discriminator.from_config(config)``.

    Submodule names follow the JAX package's variable tree (``input_conv``,
    ``blocks_<stage>_<i>``, ``attn_<stage>``, ``linear0``, ``embed``,
    ``RR_D``, ``linear1``, ``norm``), so ``models/convert.py`` maps a flax
    checkpoint onto it name for name. Spectral norm writes ``u`` and ``sv``
    back on every forward in train mode. Parameters are allocated empty: call
    ``reset_parameters(generator)`` or load a state dict.
    """

    def __init__(self, D_ch: int = 32, D_depth: int = 2, resolution: int = 256,
                 D_attn: str = "32", n_classes: int = 40, attn_type: str = "sa",
                 num_D_SVs: int = 1, num_D_SV_itrs: int = 1,
                 D_activation: str = "inplace_relu",
                 conditional_strategy: str = "Contra", SN_eps: float = 1e-6,
                 output_dim: int = 1, D_param: str = "SN", hypersphere_dim: int = 1024,
                 nonlinear_embed: bool = False, normalize_embed: bool = True,
                 prior_embed: bool = False, RRM_prx_D: bool = False,
                 RRM_embed: bool = True, n_head_D: int = 4, event_size: int = 40,
                 rrm_full_batch_sequence: bool = False, fused_attention: bool = False):
        super().__init__()
        unported = {"conditional_strategy": conditional_strategy != "Contra",
                    "attn_type": attn_type != "sa", "D_param": D_param != "SN",
                    "prior_embed": prior_embed, "RRM_prx_D": RRM_prx_D,
                    "nonlinear_embed": nonlinear_embed,
                    "rrm_full_batch_sequence": rrm_full_batch_sequence,
                    "output_dim": output_dim != 1}
        bad = [k for k, v in unported.items() if v]
        if bad:
            raise NotImplementedError(f"discriminator options not ported: {bad}")
        arch = d_arch(D_ch, D_attn)[resolution]
        self.event_size = event_size
        self.RRM_embed = RRM_embed
        self.normalize_embed = normalize_embed
        self.activation = ACTIVATIONS[D_activation]
        sn = dict(num_svs=num_D_SVs, num_itrs=num_D_SV_itrs, eps=SN_eps)
        conv = lambda cin, cout, ksize: SNConv2d(cin, cout, ksize, **sn)
        linear = functools.partial(SNLinear, **sn)

        self.input_conv = conv(1, arch["in_channels"][0], 3)
        self.layer_names = []
        for index in range(len(arch["out_channels"])):
            for d_index in range(D_depth):
                name = f"blocks_{index}_{d_index}"
                self.add_module(name, DBlock(
                    arch["in_channels"][index] if d_index == 0 else arch["out_channels"][index],
                    arch["out_channels"][index], conv, self.activation,
                    preactivation=index > 0 or d_index > 0,
                    downsample=arch["downsample"][index] and d_index == 0))
                self.layer_names.append(name)
            if arch["attention"][arch["resolution"][index]]:
                name = f"attn_{index}"
                self.add_module(name, SelfAttention2d(
                    arch["out_channels"][index], fused=fused_attention, **sn))
                self.layer_names.append(name)
        top = arch["out_channels"][-1]
        self.linear0 = linear(top, output_dim)
        self.embed = SNEmbedding(n_classes, hypersphere_dim, **sn)
        if RRM_embed:
            # SN linears inside D's RRM (reference: model.py:788-797)
            self.RR_D = RelationalReasoning(
                num_layers=1, input_dim=top, num_heads=n_head_D, dim_feedforward=512,
                linear=linear, fused=fused_attention)
        self.linear1 = linear(top, hypersphere_dim)
        if RRM_embed:
            self.norm = LayerNorm(hypersphere_dim)

    @classmethod
    def from_config(cls, config: dict) -> "Discriminator":
        """Build from a config dict (keys of ``core/config.py``). ``n_head_D``
        is not a config key, so it stays 4, as in the JAX package and the
        reference."""
        names = inspect.signature(cls).parameters
        kwargs = {k: v for k, v in config.items() if k in names}
        kwargs["event_size"] = int(config.get("n_classes", 40))
        kwargs["fused_attention"] = bool(config.get("use_pallas_attention", False))
        return cls(**kwargs)

    def reset_parameters(self, generator: torch.Generator | None = None):
        """Random init from ``generator``: orthogonal weights, zero biases and
        ``gamma``, normal ``u``, unit LayerNorm scales."""
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)

    def forward(self, x, y):
        """x: (B, H, W, 1) images in [-1, 1]; y: (B,) int labels, B a
        multiple of event_size. Computes in x's dtype with f32 parameters (the
        train step casts the reals to the compute type, where the JAX package's
        D casts its input). Returns ``(proxy (B, hyper), embed (B, hyper),
        out (B,))``."""
        h = self.input_conv(x.permute(0, 3, 1, 2))
        for name in self.layer_names:
            h = getattr(self, name)(h)
        h = torch.sum(self.activation(h), dim=(2, 3))
        out = self.linear0(h).squeeze(-1)
        proxy = self.embed(y).to(h.dtype)  # in the compute type, as the JAX SNEmbed
        if self.RRM_embed:
            top = h.shape[-1]
            h = self.RR_D(h.reshape(-1, self.event_size, top)).reshape(-1, top)
            embed = self.norm(self.linear1(h))
        else:
            embed = self.linear1(h)
        if self.normalize_embed:
            proxy = proxy / torch.clamp(torch.linalg.vector_norm(
                proxy.float(), dim=-1, keepdim=True), min=1e-12).to(proxy.dtype)
            embed = embed / torch.clamp(torch.linalg.vector_norm(
                embed.float(), dim=-1, keepdim=True), min=1e-12).to(embed.dtype)
        return proxy, embed, out
