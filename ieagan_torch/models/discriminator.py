"""Discriminator: BigGAN-deep stack, RRM over per-image features and the
contrastive (hypersphere) head (twin of ``ieagan_tpu/models/discriminator.py``;
reference: model.py:490-944).

NCHW inside; the public ``forward`` takes (B, H, W, 1) images as the JAX
package does. Forward under the Contra strategy (reference: model.py:902-944):

  h = input_conv(x); DBlocks (image attention after the D_attn stage)
  h = sum over (H, W) of relu(h)                     (B, 16ch)
  out = linear0(h)               adversarial score, from pre-RRM features
  proxy = embed[y]               spectrally normalized class embedding
  h = RR_D(h per event)          SN linears, 4 heads   [RRM_embed]
  embed = norm(linear1(h))                             (B, hyper)
  proxy = RR_Dproxy(proxy per event)                   [RRM_prx_D]
  embed = linear2(act(embed))                          [nonlinear_embed]
  proxy, embed l2-normalized                           [normalize_embed]
  returns (proxy, embed, out)

Under the Proj strategy: out = linear0(h) + <embed[y], h>, returned alone.
"""

from __future__ import annotations

import functools
import inspect

import torch
import torch.nn as nn
import torch.nn.functional as F

from ieagan_torch.models.arch import d_arch
from ieagan_torch.models.generator import ACTIVATIONS, image_attention
from ieagan_torch.ops.norm import LayerNorm
from ieagan_torch.ops.prior import prior_features
from ieagan_torch.ops.remat import remat_mode, segment
from ieagan_torch.ops.rrm import RelationalReasoning
from ieagan_torch.ops.spectral import SNConv2d, SNEmbedding, SNLinear
from ieagan_torch.parallel.collectives import all_gather_rows, batch_mesh


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
    ``linear3``/``linear4`` [prior_embed], ``RR_D``, ``linear1``, ``norm``,
    ``RR_Dproxy`` [RRM_prx_D], ``linear2`` [nonlinear_embed]), so
    ``models/convert.py`` maps a flax checkpoint onto it name for name.
    Options, as the JAX package takes them:

      * ``attn_type`` ``sa``, ``cbam`` (SN convs) or ``ila`` at the
        ``D_attn`` stages; any other type means none;
      * ``conditional_strategy="Proj"``: the score ``linear0(h) + <embed[y],
        h>`` with an SN ``embed`` of width 16·ch, returned alone as (B, 1);
      * ``prior_embed``: the class proxy at half width, ``linear3`` on the
        prior feature (``ops/prior.py``), ``linear4`` on the two concatenated;
      * ``RRM_prx_D``: ``RR_Dproxy`` over the class proxies, SN linears,
        ``n_head_D`` heads of ``hypersphere_dim / n_head_D`` (4 of 256 at the
        flagship's 1024), feed-forward width ``hypersphere_dim``;
      * ``nonlinear_embed``: ``embed = linear2(act(embed))``;
      * ``rrm_full_batch_sequence``: RR_D and RR_Dproxy take the whole input
        batch as one sequence (the reference's ``h.unsqueeze(0)``), not one
        sequence per event; under the train step's mesh, the global batch.

    ``remat`` (``remat_D`` over ``remat``, ``ops/remat.py::remat_mode``)
    recomputes activations in the backward, as the JAX discriminator's
    ``nn.remat`` does (``ieagan_tpu/models/discriminator.py:148-184``): under
    ``True`` and ``"wide"`` the stem (``input_conv`` and ``blocks_0_0``) is
    one segment, then every other block under ``True``, those of the first
    two stages under ``"wide"``; image attention is never in a segment.

    ``D_param`` is read and ignored: the layers are SN whatever its value,
    as in the JAX package (``ieagan_tpu/models/discriminator.py:141-145``).
    ``output_dim`` must be 1 (the JAX step squeezes the score). Spectral
    norm writes ``u`` and ``sv`` back on every forward in train mode.
    Parameters are allocated empty: call ``reset_parameters(generator)`` or
    load a state dict.
    """

    def __init__(self, D_ch: int = 32, D_depth: int = 2, resolution: int = 256,
                 D_attn: str = "32", n_classes: int = 40, attn_type: str = "sa",
                 num_D_SVs: int = 1, num_D_SV_itrs: int = 1,
                 D_activation: str = "inplace_relu",
                 conditional_strategy: str = "Contra", SN_eps: float = 1e-6,
                 output_dim: int = 1, hypersphere_dim: int = 1024,
                 nonlinear_embed: bool = False, normalize_embed: bool = True,
                 prior_embed: bool = False, RRM_prx_D: bool = False,
                 RRM_embed: bool = True, n_head_D: int = 4, event_size: int = 40,
                 rrm_full_batch_sequence: bool = False, fused_attention: bool = False,
                 remat=False):
        super().__init__()
        if conditional_strategy not in ("Contra", "Proj"):
            raise NotImplementedError(f"conditional_strategy {conditional_strategy!r}")
        if output_dim != 1:
            raise NotImplementedError("output_dim != 1: the train step squeezes the score")
        arch = d_arch(D_ch, D_attn)[resolution]
        self.strategy = conditional_strategy
        self.n_classes = n_classes
        self.event_size = event_size
        self.RRM_embed = RRM_embed
        self.RRM_prx_D = RRM_prx_D
        self.prior_embed = prior_embed
        self.nonlinear_embed = nonlinear_embed
        self.normalize_embed = normalize_embed
        self.full_batch_sequence = rrm_full_batch_sequence
        self.activation = ACTIVATIONS[D_activation]
        sn = dict(num_svs=num_D_SVs, num_itrs=num_D_SV_itrs, eps=SN_eps)
        conv = lambda cin, cout, ksize, bias=True: SNConv2d(cin, cout, ksize, bias=bias, **sn)
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
                attn = image_attention(attn_type, arch["out_channels"][index], conv,
                                       fused_attention, "d_sa")
                if attn is not None:
                    self.add_module(f"attn_{index}", attn)
                    self.layer_names.append(f"attn_{index}")
        self.remat = remat
        self.remat_blocks = {name for name in self.layer_names[1:]
                             if remat and name.startswith("blocks_")
                             and (remat != "wide" or int(name.split("_")[1]) < 2)}
        top = arch["out_channels"][-1]
        self.linear0 = linear(top, output_dim)
        if conditional_strategy == "Proj":
            self.embed = SNEmbedding(n_classes, top, **sn)
            return
        proxy_dim = hypersphere_dim // 2 if prior_embed else hypersphere_dim
        self.embed = SNEmbedding(n_classes, proxy_dim, **sn)
        if prior_embed:  # reference: model.py:827-834, 925-928
            self.linear3 = linear(1, hypersphere_dim // 2)
            self.linear4 = linear(proxy_dim + hypersphere_dim // 2, hypersphere_dim)
        if RRM_embed:
            # SN linears inside D's RRM (reference: model.py:788-797)
            self.RR_D = RelationalReasoning(
                num_layers=1, input_dim=top, num_heads=n_head_D, dim_feedforward=512,
                linear=linear, fused=fused_attention, site="rr_d")
        self.linear1 = linear(top, hypersphere_dim)
        if RRM_embed:
            self.norm = LayerNorm(hypersphere_dim)
        if RRM_prx_D:
            self.RR_Dproxy = RelationalReasoning(
                num_layers=1, input_dim=hypersphere_dim, num_heads=n_head_D,
                dim_feedforward=hypersphere_dim, linear=linear, fused=fused_attention,
                site="rr_dproxy")
        if nonlinear_embed:
            self.linear2 = linear(hypersphere_dim, hypersphere_dim)

    @classmethod
    def from_config(cls, config: dict) -> "Discriminator":
        """Build from a config dict (keys of ``core/config.py``). ``n_head_D``
        is not a config key, so it stays 4, as in the JAX package and the
        reference."""
        names = inspect.signature(cls).parameters
        kwargs = {k: v for k, v in config.items() if k in names}
        kwargs["event_size"] = int(config.get("n_classes", 40))
        kwargs["fused_attention"] = bool(config.get("use_pallas_attention", False))
        kwargs["remat"] = remat_mode(config, "D")
        return cls(**kwargs)

    def reset_parameters(self, generator: torch.Generator | None = None):
        """Random init from ``generator``: orthogonal weights, zero biases and
        ``gamma``, normal ``u``, unit LayerNorm scales."""
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)

    def _stem(self, x):
        """``input_conv`` and the first block: one recompute segment under
        remat (JAX's ``_stem``), whose input is the one-channel image."""
        return self.blocks_0_0(self.input_conv(x))

    def _sequences(self, rrm, h):
        """``rrm`` over ``h`` (B, d) as one sequence per event, or as one
        sequence of the whole batch: inside ``global_batch(mesh)`` the global
        batch, gathered in rank order, of which this rank keeps its rows (the
        gather's backward sums the ranks' gradients of them)."""
        if not self.full_batch_sequence:
            return rrm(h.reshape(-1, self.event_size, h.shape[-1])).reshape(h.shape)
        mesh = batch_mesh()
        out = rrm(all_gather_rows(h, mesh).unsqueeze(0)).squeeze(0)
        return out if mesh is None else out[mesh.rows(h.shape[0])]

    def forward(self, x, y):
        """x: (B, H, W, 1) images in [-1, 1]; y: (B,) int labels, B a
        multiple of event_size. Computes in x's dtype with f32 parameters (the
        train step casts the reals to the compute type, where the JAX package's
        D casts its input). Returns ``(proxy (B, hyper), embed (B, hyper),
        out (B,))`` under Contra, the score (B, 1) under Proj."""
        x = x.permute(0, 3, 1, 2)
        if self.remat:
            h = segment(self._stem, [self.input_conv, self.blocks_0_0], x)
        else:
            h = self._stem(x)
        for name in self.layer_names[1:]:
            layer = getattr(self, name)
            h = segment(layer, [layer], h) if name in self.remat_blocks else layer(h)
        h = torch.sum(self.activation(h), dim=(2, 3))
        if self.strategy == "Proj":
            emb = self.embed(y).to(h.dtype)
            return self.linear0(h) + torch.sum(emb * h, dim=1, keepdim=True)
        out = self.linear0(h).squeeze(-1)
        proxy = self.embed(y).to(h.dtype)  # in the compute type, as the JAX SNEmbed
        if self.prior_embed:
            feat = self.linear3(prior_features(y, self.n_classes).to(proxy.dtype))
            proxy = self.linear4(torch.cat([proxy, feat], dim=-1))
        if self.RRM_embed:
            embed = self.norm(self.linear1(self._sequences(self.RR_D, h)))
        else:
            embed = self.linear1(h)
        if self.RRM_prx_D:
            proxy = self._sequences(self.RR_Dproxy, proxy)
        if self.nonlinear_embed:
            embed = self.linear2(self.activation(embed))
        if self.normalize_embed:
            proxy = proxy / torch.clamp(torch.linalg.vector_norm(
                proxy.float(), dim=-1, keepdim=True), min=1e-12).to(proxy.dtype)
            embed = embed / torch.clamp(torch.linalg.vector_norm(
                embed.float(), dim=-1, keepdim=True), min=1e-12).to(embed.dtype)
        return proxy, embed, out
