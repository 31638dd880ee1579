"""Generator: BigGAN-deep stack with RRM over class-proxy embeddings (twin of
``ieagan_tpu/models/generator.py``; reference: model.py:139-487).

NCHW inside; the public ``forward`` returns (B, H, W, C) as the JAX package
does, C = ``output_channels`` (1, the sensor images, unless a configuration
sets it: BigGAN-deep's RGB head takes 3). The per-image random degrees of freedom ``rdof`` are an explicit input
(the JAX model draws them inside, ``generator.py:181``), so callers control
every random number.

Forward:
  y = shared[labels]                                (B, shared_dim)
  y = linear_f([y, rdof])                           (B, 128)   [RRM_prx_G]
  y = RR_G(y grouped per event)                     (B, 128)
  z = [y, z]; cond = z                              (B, 256)   [hier]
  h = linear(z) -> (B, 16ch, 4, 4*H_base)           NCHW, as the reference
  stages x depth deep-bottleneck GBlocks (ccbn conditioned on cond)
  out = tanh(conv(relu(bn(h)))) in f32              (B, 256, 768, C)
"""

from __future__ import annotations

import functools
import inspect

import torch
import torch.nn as nn
import torch.nn.functional as F

from ieagan_torch.models.arch import g_arch
from ieagan_torch.ops.attention import ILA, CBAMAttention, SelfAttention2d
from ieagan_torch.ops.norm import BatchNorm, ClassCondBatchNorm
from ieagan_torch.ops.prior import prior_features
from ieagan_torch.ops.remat import remat_mode, segment
from ieagan_torch.ops.rrm import RelationalReasoning
from ieagan_torch.ops.spectral import Conv2d, Embedding, Linear, SNConv2d, SNLinear

ACTIVATIONS = {
    "inplace_relu": F.relu,
    "relu": F.relu,
    "leaky_relu": functools.partial(F.leaky_relu, negative_slope=0.2),
}


def upsample_2x(x):
    """Nearest-neighbour 2x upsample, NCHW (reference F.interpolate
    scale_factor=2, model.py:338)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def image_attention(attn_type: str, ch: int, conv, fused: bool, site: str):
    """The image attention of ``attn_type`` over ``ch`` channels, built with
    ``conv(cin, cout, ksize, bias=...)``, or None for a type that means no
    attention, as in the JAX package (``ieagan_tpu/models/generator.py:225-238``,
    ``discriminator.py:187-199``). SA's kernel choice follows ``fused``, its
    span's name ``site``."""
    if attn_type == "sa":
        return SelfAttention2d(ch, fused=fused, conv=conv, site=site)
    if attn_type == "cbam":
        return CBAMAttention(ch, conv)
    if attn_type == "ila":
        return ILA(ch)
    return None


class GBlock(nn.Module):
    """BigGAN-deep generator bottleneck block (reference: model.py:16-71):
    1x1 -> 3x3 -> 3x3 -> 1x1 convs at in/4 hidden width, ccbn+activation
    pre-activations, channel-drop shortcut, optional 2x upsample."""

    def __init__(self, in_channels: int, out_channels: int, conv, bn, activation,
                 upsample: bool = False, channel_ratio: int = 4):
        super().__init__()
        hidden = in_channels // channel_ratio
        self.out_channels = out_channels
        self.in_channels = in_channels
        self.activation = activation
        self.upsample = upsample
        self.bn1 = bn(in_channels)
        self.conv1 = conv(in_channels, hidden, 1)
        self.bn2 = bn(hidden)
        self.conv2 = conv(hidden, hidden, 3)
        self.bn3 = bn(hidden)
        self.conv3 = conv(hidden, hidden, 3)
        self.bn4 = bn(hidden)
        self.conv4 = conv(hidden, out_channels, 1)

    def forward(self, x, y, accumulate_standing: bool = False):
        act = self.activation
        h = self.conv1(act(self.bn1(x, y, accumulate_standing)))
        h = act(self.bn2(h, y, accumulate_standing))
        if self.in_channels != self.out_channels:
            x = x[:, : self.out_channels]
        if self.upsample:
            h = upsample_2x(h)
            x = upsample_2x(x)
        h = self.conv2(h)
        h = self.conv3(act(self.bn3(h, y, accumulate_standing)))
        h = self.conv4(act(self.bn4(h, y, accumulate_standing)))
        return h + x


class Generator(nn.Module):
    """The port's Generator; build with ``Generator.from_config(config)``.

    Submodule names follow the JAX package's variable tree (``shared``,
    ``linear0``/``linear1`` [prior_embed], ``linear_f``, ``RR_G``, ``linear``,
    ``blocks_<stage>_<i>``, ``attn_<stage>``, ``output_bn``, ``output_conv``),
    so ``models/convert.py`` maps a flax checkpoint onto it name for name.
    Options, as the JAX package takes them:

      * ``G_attn`` stages get image attention of ``attn_type`` ``sa``,
        ``cbam`` or ``ila`` after their last block (at the last stage, between
        that block and ``output_bn``); any other ``attn_type`` means none;
      * ``prior_embed``: ``shared`` at half width, ``linear0`` on the prior
        feature (``ops/prior.py``), ``linear1`` on the two concatenated;
      * ``G_param != "SN"``: plain linears and convs (with bias) where SN
        ones are; ccbn's linears stay bias-free. The JAX generator raises
        here, and in SA/CBAM under it, because flax's ``nn.Conv`` takes no
        ``update_stats``; the port builds what that code describes;
      * ``hier=False``: z alone goes into ``linear``, and every ccbn is
        conditioned on the class embedding alone;
      * ``norm_style`` goes to every ccbn (``ops/norm.py``);
      * ``output_channels``: the image channels of ``output_conv`` (1 by
        default; no key of ``core/config.py``, so only a configuration that
        sets it, such as BigGAN-deep 256's RGB, changes it).

    ``remat`` (``remat_G`` over ``remat``, ``ops/remat.py::remat_mode``)
    recomputes activations in the backward, as the JAX generator's
    ``nn.remat`` does (``ieagan_tpu/models/generator.py:214-287``): under
    ``True`` every block is a segment, under ``"wide"`` only the blocks of
    the last two stages; under both, the tail (the last block, an attention
    at the last stage, ``output_bn``, ``output_conv`` and the tanh) is one
    segment. It changes memory and time, not numbers. Parameters are
    allocated empty: call ``reset_parameters(generator)`` or load a state
    dict.
    """

    def __init__(self, G_ch: int = 32, G_depth: int = 2, dim_z: int = 128,
                 bottom_width: int = 4, H_base: int = 3, resolution: int = 256,
                 G_attn: str = "0", n_classes: int = 40, shared_dim: int = 128,
                 rdof_dim: int = 4, hier: bool = True,
                 G_activation: str = "inplace_relu", BN_eps: float = 1e-5,
                 SN_eps: float = 1e-6, num_G_SVs: int = 1, num_G_SV_itrs: int = 1,
                 attn_type: str = "sa", RRM_prx_G: bool = True,
                 normalized_proxy_G: bool = False, prior_embed: bool = False,
                 n_head_G: int = 2, G_param: str = "SN", norm_style: str = "bn",
                 event_size: int = 40, fused_attention: bool = False, remat=False,
                 output_channels: int = 1):
        super().__init__()
        arch = g_arch(G_ch, G_attn)[resolution]
        self.arch = arch
        self.bottom_width = bottom_width
        self.H_base = H_base
        self.n_classes = n_classes
        self.event_size = event_size
        self.RRM_prx_G = RRM_prx_G
        self.normalized_proxy_G = normalized_proxy_G
        self.prior_embed = prior_embed
        self.hier = hier
        self.activation = ACTIVATIONS[G_activation]
        shared_dim = shared_dim if shared_dim > 0 else dim_z

        sn = dict(num_svs=num_G_SVs, num_itrs=num_G_SV_itrs, eps=SN_eps)
        if G_param == "SN":
            linear = functools.partial(SNLinear, **sn)
            conv = lambda cin, cout, ksize, bias=True: SNConv2d(cin, cout, ksize, bias=bias,
                                                                **sn)
        else:
            linear = Linear
            conv = Conv2d
        y_dim = 128 if RRM_prx_G else shared_dim
        cond_dim = y_dim + dim_z if hier else y_dim
        # ccbn's linears are bias-free (reference: model.py:264-268)
        bn = lambda c: ClassCondBatchNorm(
            c, cond_dim, functools.partial(linear, bias=False), eps=BN_eps,
            norm_style=norm_style)

        if prior_embed:  # reference: model.py:284-292, 455-460
            self.shared = Embedding(n_classes, shared_dim // 2)
            self.linear0 = linear(1, shared_dim // 2)
            self.linear1 = linear(shared_dim // 2 * 2, shared_dim)
        else:
            self.shared = Embedding(n_classes, shared_dim)
        if RRM_prx_G:
            self.linear_f = linear(shared_dim + rdof_dim, 128)
            self.RR_G = RelationalReasoning(
                num_layers=1, input_dim=128, num_heads=n_head_G,
                dim_feedforward=128, linear=Linear, fused=fused_attention, site="rr_g")
        self.linear = linear(cond_dim if hier else dim_z,
                             arch["in_channels"][0] * bottom_width ** 2 * H_base)
        self.layer_names = []
        for index in range(len(arch["out_channels"])):
            for g_index in range(G_depth):
                name = f"blocks_{index}_{g_index}"
                self.add_module(name, GBlock(
                    arch["in_channels"][index],
                    (arch["in_channels"][index] if g_index == 0
                     else arch["out_channels"][index]),
                    conv, bn, self.activation,
                    upsample=arch["upsample"][index] and g_index == G_depth - 1))
                self.layer_names.append(name)
            if arch["attention"][arch["resolution"][index]]:
                attn = image_attention(attn_type, arch["out_channels"][index], conv,
                                       fused_attention, "g_sa")
                if attn is not None:
                    self.add_module(f"attn_{index}", attn)
                    self.layer_names.append(f"attn_{index}")
        self.output_bn = BatchNorm(arch["out_channels"][-1], eps=1e-5)
        self.output_conv = conv(arch["out_channels"][-1], output_channels, 3)
        # the tail starts at the last block (JAX's _tail); remat makes a
        # segment of each block before it from stage ``first`` on
        last = len(arch["out_channels"]) - 1
        self.tail_start = self.layer_names.index(f"blocks_{last}_{G_depth - 1}")
        self.remat = remat
        first = last - 1 if remat == "wide" else 0
        self.remat_blocks = {name for name in self.layer_names[:self.tail_start]
                             if remat and name.startswith("blocks_")
                             and int(name.split("_")[1]) >= first}

    @classmethod
    def from_config(cls, config: dict) -> "Generator":
        """Build from a config dict (keys of ``core/config.py``)."""
        names = inspect.signature(cls).parameters
        kwargs = {k: v for k, v in config.items() if k in names}
        kwargs["event_size"] = int(config.get("n_classes", 40))
        kwargs["fused_attention"] = bool(config.get("use_pallas_attention", False))
        kwargs["remat"] = remat_mode(config, "G")
        return cls(**kwargs)

    def reset_parameters(self, generator: torch.Generator | None = None):
        """Random init from ``generator``: orthogonal weights, zero biases,
        normal ``u``, unit gains, zero/one running stats. Each submodule
        resets only what it owns."""
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)

    def forward(self, z, y, rdof=None, accumulate_standing: bool = False):
        """z: (B, dim_z); y: (B,) int labels; rdof: (B, rdof_dim), required
        when RRM_prx_G. B = events * event_size. Computes in z's dtype with
        f32 parameters, normalization statistics and tanh, as the JAX
        package does. Returns (B, H, W, output_channels) in [-1, 1]."""
        y_emb = self.shared(y).to(z.dtype)
        if self.prior_embed:
            feat = self.linear0(prior_features(y, self.n_classes).to(y_emb.dtype))
            y_emb = self.linear1(torch.cat([y_emb, feat], dim=-1))
        if self.RRM_prx_G:
            if rdof is None:
                raise ValueError("RRM_prx_G needs rdof of shape (B, rdof_dim)")
            y_emb = self.linear_f(torch.cat([y_emb, rdof.to(y_emb.dtype)], dim=-1))
            y_emb = self.RR_G(y_emb.reshape(-1, self.event_size, 128)).reshape(-1, 128)
            if self.normalized_proxy_G:
                y_emb = F.normalize(y_emb, dim=-1, eps=1e-12)
        if self.hier:
            cond = h = torch.cat([y_emb, z.to(y_emb.dtype)], dim=-1)
        else:
            cond, h = y_emb, z.to(y_emb.dtype)
        h = self.linear(h).reshape(
            cond.shape[0], self.arch["in_channels"][0], self.bottom_width,
            self.bottom_width * self.H_base)
        for name in self.layer_names[:self.tail_start]:
            if name in self.remat_blocks:
                layer = getattr(self, name)
                h = segment(functools.partial(layer, accumulate_standing=accumulate_standing),
                            [layer], h, cond)
            else:
                h = self._layer(name, h, cond, accumulate_standing)
        tail = functools.partial(self._tail, accumulate_standing=accumulate_standing)
        if self.remat:
            names = self.layer_names[self.tail_start:]
            h = segment(tail, [getattr(self, n) for n in names] + [self.output_bn,
                                                                   self.output_conv], h, cond)
        else:
            h = tail(h, cond)
        return h.permute(0, 2, 3, 1)

    def _layer(self, name, h, cond, accumulate_standing):
        layer = getattr(self, name)
        return layer(h, cond, accumulate_standing) if isinstance(layer, GBlock) else layer(h)

    def _tail(self, h, cond, accumulate_standing):
        """The last block, an attention at the last stage, the output head
        and the tanh: one recompute segment under remat (JAX's ``_tail``)."""
        for name in self.layer_names[self.tail_start:]:
            h = self._layer(name, h, cond, accumulate_standing)
        h = self.output_bn(h, accumulate_standing)
        h = self.output_conv(self.activation(h))
        return torch.tanh(h.float()).to(h.dtype)
