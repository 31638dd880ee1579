"""Plain PyTorch reference of BigGAN-deep's generator forward, float32.

Written from the published model (Brock, Donahue, Simonyan, "Large Scale GAN
Training for High Fidelity Natural Image Synthesis", ICLR 2019, arXiv:1809.11096,
appendix B; ``BigGANdeep.py`` and ``layers.py`` of
https://github.com/ajbrock/BigGAN-PyTorch, ``G_arch[256]``): a shared class
embedding concatenated with z (``hier``) feeds the first linear map and every
class-conditional batch norm (ccbn); bottleneck GBlocks (1x1, 3x3, 3x3, 1x1
at a quarter of the input width, ccbn and ReLU before each conv, the
shortcut dropping channels and upsampling 2x nearest), two a resolution
from 4x4 to 256x256; SA-GAN self-attention at 64x64 with k and v max-pooled
2x2 and no 1/sqrt(d); the output batch norm, ReLU, a 3x3 conv to the image
channels, tanh. Every conv and linear map, the ccbn's among them, is
spectrally normalised with one power-iteration step from the stored ``u``.

Functions over one flat dict ``S`` of tensors, no module, no kernel, no
cache; nothing of the program under test. ``g_spec(cfg)`` lists every entry
of the state with its shape and kind, under the names the program loads
(``blocks_<stage>_<i>.conv1.weight``; ``.u`` a spectral norm's vector,
``.sv`` its logged singular value; ``.mean``/``.var`` a batch norm's running
statistics; ``bn<k>.gain``/``.bias`` a ccbn's two bias-free linear maps;
``attn_<stage>``, ``output_bn``, ``output_conv``), the layout of the
benchmark's IEA-GAN reference. ``generator(cfg, S, z, y)`` is the forward in
eval mode. The configuration keys read: ``G_ch``, ``G_depth``,
``resolution`` (256, or 64 for tests), ``H_base``, ``G_attn``,
``n_classes``, ``dim_z``, ``shared_dim``, ``BN_eps``, ``SN_eps``,
``output_channels``.

Departures from the published code, each without effect on the numbers of
the published configuration:

- eval mode only: running statistics in every batch norm, ``u`` not
  advanced (the published SN runs its power step on every forward and
  writes ``u`` back only in training);
- names: the published ``stored_mean``/``stored_var`` are ``mean``/``var``,
  ``output_layer.0``/``.2`` are ``output_bn``/``output_conv``, and the
  blocks are numbered by stage and depth;
- the image channels come from ``output_channels`` (3 published) and the
  first map's width from ``H_base`` (1 published: a square 4x4 start);
- a 64x64 table (``resolution`` 64, published for BigGAN-deep at 64) so that
  tests run at a small size;
- ``precision="bfloat16"`` rounds each product's operands and result to
  bfloat16 (attention's scores excepted, which a fused kernel keeps in
  float32): the lower-precision control, not the published model.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# (in, out) channel multiples of G_ch and the resolution after each stage
TABLES = {
    256: dict(in_mul=[16, 16, 8, 8, 4, 2], out_mul=[16, 8, 8, 4, 2, 1],
              resolution=[8, 16, 32, 64, 128, 256]),
    64: dict(in_mul=[16, 16, 8, 4], out_mul=[16, 8, 4, 2], resolution=[8, 16, 32, 64]),
}
BOTTOM = 4


def layout(cfg):
    """[(kind, name, args)] of G's layers in forward order: ``gblock`` with
    (in, out, upsample), ``sa`` with (channels,)."""
    ch, depth, table = cfg["G_ch"], cfg["G_depth"], TABLES[cfg["resolution"]]
    attn = {int(a) for a in str(cfg["G_attn"]).split("_")}
    out = []
    for i, (mi, mo, res) in enumerate(zip(table["in_mul"], table["out_mul"],
                                          table["resolution"])):
        for j in range(depth):
            out.append(("gblock", f"blocks_{i}_{j}",
                        (ch * mi, ch * mi if j < depth - 1 else ch * mo, j == depth - 1)))
        if res in attn:
            out.append(("sa", f"attn_{i}", (ch * mo,)))
    return out


def top_channels(cfg):
    return cfg["G_ch"] * TABLES[cfg["resolution"]]["in_mul"][0]


def last_channels(cfg):
    return cfg["G_ch"] * TABLES[cfg["resolution"]]["out_mul"][-1]


# ----------------------------------------------------------------------------
# the state's layout

def _sn(out, name, shape, bias):
    out[f"{name}.weight"] = (shape, "weight")
    if bias:
        out[f"{name}.bias"] = ((shape[0],), "zero")
    out[f"{name}.u"] = ((1, shape[0]), "u")
    out[f"{name}.sv"] = ((1,), "one")


def _bn_stats(out, name, c):
    out[f"{name}.mean"] = ((c,), "zero")
    out[f"{name}.var"] = ((c,), "one")
    out[f"{name}.accumulation_counter"] = ((), "zero")


def g_spec(cfg):
    """{name: (shape, kind)} of G's state. Kinds: ``weight``, ``u``,
    ``zero``, ``one``, ``gamma`` (the SA residual gain)."""
    out = {}
    cond = cfg["shared_dim"] + cfg["dim_z"]
    out["shared.weight"] = ((cfg["n_classes"], cfg["shared_dim"]), "weight")
    _sn(out, "linear", (top_channels(cfg) * BOTTOM * BOTTOM * cfg["H_base"], cond), True)
    for kind, name, args in layout(cfg):
        if kind == "sa":
            c = args[0]
            for conv, cin, cout in (("theta", c, c // 8), ("phi", c, c // 8),
                                    ("g", c, c // 2), ("o", c // 2, c)):
                _sn(out, f"{name}.{conv}", (cout, cin, 1, 1), False)
            out[f"{name}.gamma"] = ((), "gamma")
            continue
        cin, cout, _ = args
        hid = cin // 4
        for k, (bn_c, conv, shape) in enumerate((
                (cin, "conv1", (hid, cin, 1, 1)), (hid, "conv2", (hid, hid, 3, 3)),
                (hid, "conv3", (hid, hid, 3, 3)), (hid, "conv4", (cout, hid, 1, 1))), 1):
            _bn_stats(out, f"{name}.bn{k}", bn_c)
            _sn(out, f"{name}.bn{k}.gain", (bn_c, cond), False)
            _sn(out, f"{name}.bn{k}.bias", (bn_c, cond), False)
            _sn(out, f"{name}.{conv}", shape, True)
    last = last_channels(cfg)
    out["output_bn.gain"] = ((last,), "one")
    out["output_bn.bias"] = ((last,), "zero")
    _bn_stats(out, "output_bn", last)
    _sn(out, "output_conv", (cfg["output_channels"], last, 3, 3), True)
    return out


def sn_names(cfg):
    """The spectrally normalised layers, in forward order."""
    names = ["linear"]
    for kind, name, _ in layout(cfg):
        if kind == "sa":
            names += [f"{name}.{c}" for c in ("theta", "phi", "g", "o")]
        else:
            for k in range(1, 5):
                names += [f"{name}.bn{k}.gain", f"{name}.bn{k}.bias", f"{name}.conv{k}"]
    return names + ["output_conv"]


# ----------------------------------------------------------------------------
# the forward

def spectral(S, name, eps):
    """W / sigma(W): one power-iteration step from ``u`` (``u`` unchanged)."""
    w = S[f"{name}.weight"]
    w_mat = w.reshape(w.shape[0], -1)
    v = S[f"{name}.u"] @ w_mat
    v = v / torch.clamp(v.norm(), min=eps)
    u = v @ w_mat.T
    u = u / torch.clamp(u.norm(), min=eps)
    sigma = (v @ w_mat.T @ u.T).reshape(())
    return w / sigma


class _Products:
    """Linear maps, convolutions and matrix products in float32, or with
    operands and results rounded to bfloat16 (the control)."""

    def __init__(self, precision):
        if precision not in ("float32", "bfloat16"):
            raise ValueError(f"unknown precision {precision!r}")
        self.round = precision == "bfloat16"

    def q(self, x):
        return x.to(torch.bfloat16).float() if self.round else x

    def linear(self, x, w, b=None):
        y = self.q(x) @ self.q(w).T
        return self.q(y if b is None else y + b)

    def conv(self, x, w, b=None):
        return self.q(F.conv2d(self.q(x), self.q(w), b, padding=w.shape[-1] // 2))

    def matmul(self, a, b, stored=True):
        y = self.q(a) @ self.q(b)
        return self.q(y) if stored else y


def _bn(S, name, x, eps):
    """(x - running mean) / sqrt(running var + eps), per channel."""
    mean, var = S[f"{name}.mean"], S[f"{name}.var"]
    return (x - mean[:, None, None]) / torch.sqrt(var + eps)[:, None, None]


def _ccbn(p, S, W, name, x, cond, eps):
    gain = 1.0 + p.linear(cond, W[f"{name}.gain"])
    bias = p.linear(cond, W[f"{name}.bias"])
    return _bn(S, name, x, eps) * gain[:, :, None, None] + bias[:, :, None, None]


def _gblock(p, S, W, name, cin, cout, up, eps, x, cond):
    conv = lambda n, t: p.conv(t, W[f"{name}.{n}"], S[f"{name}.{n}.bias"])
    h = conv("conv1", F.relu(_ccbn(p, S, W, f"{name}.bn1", x, cond, eps)))
    h = F.relu(_ccbn(p, S, W, f"{name}.bn2", h, cond, eps))
    if cin != cout:
        x = x[:, :cout]
    if up:
        h = F.interpolate(h, scale_factor=2, mode="nearest")
        x = F.interpolate(x, scale_factor=2, mode="nearest")
    h = conv("conv2", h)
    h = conv("conv3", F.relu(_ccbn(p, S, W, f"{name}.bn3", h, cond, eps)))
    h = conv("conv4", F.relu(_ccbn(p, S, W, f"{name}.bn4", h, cond, eps)))
    return h + x


def _self_attention(p, S, W, name, x):
    """SA-GAN: q from theta, k and v from phi and g max-pooled 2x2,
    softmax(q kᵀ) v with no 1/sqrt(d), the o conv, residual through gamma."""
    b, c, h, w = x.shape
    q = p.conv(x, W[f"{name}.theta"]).flatten(2).transpose(1, 2)
    k = F.max_pool2d(p.conv(x, W[f"{name}.phi"]), 2).flatten(2).transpose(1, 2)
    v = F.max_pool2d(p.conv(x, W[f"{name}.g"]), 2).flatten(2).transpose(1, 2)
    s = p.matmul(q, k.transpose(1, 2), stored=False)
    o = p.matmul(torch.softmax(s, dim=-1), v).transpose(1, 2).reshape(b, c // 2, h, w)
    return S[f"{name}.gamma"] * p.conv(o, W[f"{name}.o"]) + x


@torch.no_grad()
def generator(cfg, S, z, y, precision: str = "float32"):
    """G(z, y) in eval mode -> (B, H, W, output_channels) in [-1, 1],
    float32. Sets TF32 off for CUDA products first."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p = _Products(precision)
    W = {n: spectral(S, n, cfg["SN_eps"]) for n in sn_names(cfg)}
    cond = torch.cat([S["shared.weight"][y], z.float()], 1)
    h = p.linear(cond, W["linear"], S["linear.bias"]).reshape(
        z.shape[0], top_channels(cfg), BOTTOM, BOTTOM * cfg["H_base"])
    for kind, name, args in layout(cfg):
        if kind == "sa":
            h = _self_attention(p, S, W, name, h)
        else:
            h = _gblock(p, S, W, name, *args, cfg["BN_eps"], h, cond)
    h = _bn(S, "output_bn", h, 1e-5) * S["output_bn.gain"][:, None, None] \
        + S["output_bn.bias"][:, None, None]
    h = torch.tanh(p.conv(F.relu(h), W["output_conv"], S["output_conv.bias"]))
    return h.permute(0, 2, 3, 1)
