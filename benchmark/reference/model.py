"""Plain PyTorch reference of IEA-GAN's generator and discriminator.

Written from the published model (Hashemi et al., "Intra-Event Aware
Imaging", IEA-GAN's `model.py`, `layers.py` and `RRM.py`: a BigGAN-deep
generator conditioned through class-conditional batch norm on a relational
reasoning module over the sensors of an event, and a BigGAN-deep
discriminator with a contrastive head) and independent of the program under
test: functions over a dict of tensors, no module, no kernel, no cache.

State is one flat dict ``S`` of tensors whose names are the layout both
sides load (``blocks_0_0.conv1.weight``, ``.u`` the spectral norm's vector,
``.mean``/``.var`` a batch norm's running statistics). ``spec(cfg)`` lists
every entry with its shape and kind; the harness makes the values from the
seed and hands the same dict to the program and to this reference.

Products run through ``Ops``: in float32 as stated, or computed in a
narrower type (the lower-precision control). Layout NCHW inside,
images NHWC at the boundaries, as the program takes and gives them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _cast(x, fmt):
    """x rounded to ``fmt`` and back to float32; a float8 type takes one
    scale per tensor, set by its largest entry."""
    if fmt == torch.bfloat16:
        return x.to(fmt).float()
    scale = x.abs().amax().clamp(min=1e-30) / torch.finfo(fmt).max
    return (x / scale).to(fmt).float() * scale


class _Round(torch.autograd.Function):
    """A product's operand rounded to ``fwd`` in the forward, its gradient
    to ``bwd`` in the backward (float8: e4m3 forward, e5m2 backward, as
    float8 training takes them)."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return _cast(x, fwd)

    @staticmethod
    def backward(ctx, g):
        return _cast(g, ctx.bwd), None, None


FORMATS = {"bfloat16": (torch.bfloat16, torch.bfloat16),
           "float8": (torch.float8_e4m3fn, torch.float8_e5m2)}


class Ops:
    """The products of the reference: linear maps, convolutions and matrix
    products in float32 as stated, or, for the lower-precision control,
    computed in ``precision`` (``bfloat16``, ``float8``): each product's
    operands and its result rounded to it, as a program computing in that
    type reads and stores them, with the gradients rounded alike."""

    def __init__(self, precision: str = "float32"):
        if precision != "float32" and precision not in FORMATS:
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision

    def q(self, x):
        if self.precision == "float32":
            return x
        return _Round.apply(x, *FORMATS[self.precision])

    def linear(self, x, w, b=None):
        y = self.q(x) @ self.q(w).T
        return self.q(y if b is None else y + b)

    def conv(self, x, w, b=None):
        return self.q(F.conv2d(self.q(x), self.q(w), b, padding=w.shape[-1] // 2))

    def matmul(self, a, b, stored: bool = True):
        """``stored=False`` for attention's scores, which a fused kernel
        keeps in its float32 accumulators."""
        y = self.q(a) @ self.q(b)
        return self.q(y) if stored else y


# ----------------------------------------------------------------------------
# widths, as the published architecture tables give them (resolution 256)

G_STAGES = dict(in_mul=[16, 16, 8, 8, 4, 2], out_mul=[16, 8, 8, 4, 2, 1],
                resolution=[8, 16, 32, 64, 128, 256])
D_STAGES = dict(in_mul=[1, 2, 4, 8, 8, 16], out_mul=[2, 4, 8, 8, 16, 16],
                downsample=[True] * 6, resolution=[128, 64, 32, 16, 8, 4])


def _attn(s):
    return {int(a) for a in str(s).split("_")}


def g_layout(cfg):
    """[(kind, name, args)] of G's layers in forward order."""
    ch, depth = cfg["G_ch"], cfg["G_depth"]
    if cfg["resolution"] != 256:
        table = _small_g(cfg["resolution"])
    else:
        table = G_STAGES
    att = _attn(cfg["G_attn"])
    out = []
    for i, (mi, mo, res) in enumerate(zip(table["in_mul"], table["out_mul"],
                                          table["resolution"])):
        for j in range(depth):
            cin = ch * mi
            cout = ch * mi if j < depth - 1 else ch * mo
            out.append(("gblock", f"blocks_{i}_{j}", (cin, cout, j == depth - 1)))
        if res in att:
            out.append(("sa", f"attn_{i}", (ch * mo,)))
    return out


def d_layout(cfg):
    ch, depth = cfg["D_ch"], cfg["D_depth"]
    table = D_STAGES if cfg["resolution"] == 256 else _small_d(cfg["resolution"])
    att = _attn(cfg["D_attn"])
    out = []
    for i, (mi, mo, down, res) in enumerate(zip(table["in_mul"], table["out_mul"],
                                                table["downsample"], table["resolution"])):
        for j in range(depth):
            cin = ch * mi if j == 0 else ch * mo
            out.append(("dblock", f"blocks_{i}_{j}",
                        (cin, ch * mo, i > 0 or j > 0, down and j == 0)))
        if res in att:
            out.append(("sa", f"attn_{i}", (ch * mo,)))
    return out


def _small_g(res):
    """The published table for the small resolution the tests run."""
    return {64: dict(in_mul=[16, 16, 8, 4], out_mul=[16, 8, 4, 2], resolution=[8, 16, 32, 64])}[res]


def _small_d(res):
    return {64: dict(in_mul=[1, 2, 4, 8], out_mul=[2, 4, 8, 16], downsample=[True] * 4,
                     resolution=[32, 16, 8, 4])}[res]


def g_top(cfg):
    return cfg["G_ch"] * (G_STAGES if cfg["resolution"] == 256
                          else _small_g(cfg["resolution"]))["in_mul"][0]


def g_last(cfg):
    return cfg["G_ch"] * (G_STAGES if cfg["resolution"] == 256
                          else _small_g(cfg["resolution"]))["out_mul"][-1]


def d_top(cfg):
    return cfg["D_ch"] * (D_STAGES if cfg["resolution"] == 256
                          else _small_d(cfg["resolution"]))["out_mul"][-1]


# ----------------------------------------------------------------------------
# the state's layout

def _sn(out, name, shape, bias):
    out[f"{name}.weight"] = (shape, "weight")
    if bias:
        out[f"{name}.bias"] = ((shape[0],), "zero")
    out[f"{name}.u"] = ((1, shape[0]), "u")
    out[f"{name}.sv"] = ((1,), "one")


def _plain(out, name, shape, bias=True):
    out[f"{name}.weight"] = (shape, "weight")
    if bias:
        out[f"{name}.bias"] = ((shape[0],), "zero")


def _ln(out, name, dim):
    out[f"{name}.weight"] = ((dim,), "one")
    out[f"{name}.bias"] = ((dim,), "zero")


def _rrm(out, name, dim, ff, sn: bool):
    add = (lambda n, s: _sn(out, n, s, True)) if sn else (lambda n, s: _plain(out, n, s))
    p = f"{name}.layers_0"
    add(f"{p}.self_attn.qkv_proj", (3 * dim, dim))
    add(f"{p}.self_attn.o_proj", (dim, dim))
    _ln(out, f"{p}.norm1", dim)
    _ln(out, f"{p}.norm2", dim)
    add(f"{p}.linear1", (ff, dim))
    add(f"{p}.linear2", (dim, ff))
    _ln(out, f"{name}.norm", dim)


def _sa(out, name, c):
    for conv, cin, cout in (("theta", c, c // 8), ("phi", c, c // 8), ("g", c, c // 2),
                            ("o", c // 2, c)):
        _sn(out, f"{name}.{conv}", (cout, cin, 1, 1), False)
    out[f"{name}.gamma"] = ((), "gamma")


def _bn_stats(out, name, c):
    out[f"{name}.mean"] = ((c,), "zero")
    out[f"{name}.var"] = ((c,), "one")
    out[f"{name}.accumulation_counter"] = ((), "zero")


def g_spec(cfg):
    """{name: (shape, kind)} of G's state. Kinds: ``weight`` (normal, std
    1/sqrt(fan-in)), ``u`` (normal), ``zero``, ``one``, ``gamma`` (the SA
    residual gain)."""
    out = {}
    shared, dim_z = cfg["shared_dim"], cfg["dim_z"]
    out["shared.weight"] = ((cfg["n_classes"], shared), "weight")
    y_dim = shared
    if cfg["RRM_prx_G"]:
        _sn(out, "linear_f", (128, shared + cfg["rdof_dim"]), True)
        _rrm(out, "RR_G", 128, 128, sn=False)
        y_dim = 128
    cond = y_dim + dim_z
    top = g_top(cfg)
    _sn(out, "linear", (top * 4 * 4 * cfg["H_base"], cond), True)
    for kind, name, args in g_layout(cfg):
        if kind == "sa":
            _sa(out, name, args[0])
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
    last = g_last(cfg)
    out["output_bn.gain"] = ((last,), "one")
    out["output_bn.bias"] = ((last,), "zero")
    _bn_stats(out, "output_bn", last)
    _sn(out, "output_conv", (1, last, 3, 3), True)
    return out


def d_spec(cfg):
    out = {}
    ch0 = cfg["D_ch"] * (D_STAGES if cfg["resolution"] == 256
                         else _small_d(cfg["resolution"]))["in_mul"][0]
    _sn(out, "input_conv", (ch0, 1, 3, 3), True)
    for kind, name, args in d_layout(cfg):
        if kind == "sa":
            _sa(out, name, args[0])
            continue
        cin, cout, _, _ = args
        hid = cout // 4
        _sn(out, f"{name}.conv1", (hid, cin, 1, 1), True)
        _sn(out, f"{name}.conv2", (hid, hid, 3, 3), True)
        _sn(out, f"{name}.conv3", (hid, hid, 3, 3), True)
        _sn(out, f"{name}.conv4", (cout, hid, 1, 1), True)
        if cin != cout:
            _sn(out, f"{name}.conv_sc", (cout - cin, cin, 1, 1), True)
    top, hyper = d_top(cfg), cfg["hypersphere_dim"]
    _sn(out, "linear0", (1, top), True)
    out["embed.weight"] = ((cfg["n_classes"], hyper), "weight")
    out["embed.u"] = ((1, cfg["n_classes"]), "u")
    out["embed.sv"] = ((1,), "one")
    _rrm(out, "RR_D", top, 512, sn=True)
    _sn(out, "linear1", (hyper, top), True)
    _ln(out, "norm", hyper)
    return out


# ----------------------------------------------------------------------------
# spectral norm

def spectral(S, name, eps, update: bool, fresh=None):
    """W / sigma(W) for ``name``: one power-iteration step from ``u``, the
    singular value with gradient through W (u and v held constant). With
    ``update`` the new ``u`` (and ``sv``) are written back into ``S``, as a
    forward in train mode does; ``fresh`` collects them instead when given."""
    w = S[f"{name}.weight"]
    w_mat = w.reshape(w.shape[0], -1)
    u = S[f"{name}.u"]
    wd = w_mat.detach()
    v = u @ wd
    v = v / torch.clamp(v.norm(), min=eps)
    u2 = v @ wd.T
    u2 = u2 / torch.clamp(u2.norm(), min=eps)
    sigma = (v @ w_mat.T @ u2.T).reshape(1)
    if update:
        target = S if fresh is None else fresh
        target[f"{name}.u"] = u2.detach()
        target[f"{name}.sv"] = sigma.detach()
    return (w_mat / sigma).reshape(w.shape)


def sn_weights(S, names, eps, update):
    """The normalized weights of ``names``, each layer's power iteration run
    once (a forward pass's worth)."""
    fresh = {}
    out = {n: spectral(S, n, eps, update, fresh) for n in names}
    S.update(fresh)
    return out


# ----------------------------------------------------------------------------
# shared pieces

def layer_norm(x, w, b, eps=1e-5):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def attention(ops, q, k, v, scale):
    """softmax(scale q k^T) v over the last-but-one axis."""
    s = ops.matmul(q, k.transpose(-1, -2), stored=False) * scale
    return ops.matmul(torch.softmax(s, dim=-1), v)


def rrm(ops, S, W, name, x, heads):
    """Pre-LN transformer encoder (one layer) and a final LayerNorm over x
    (events, sensors, dim). ``W`` maps a linear's name to its weight
    (normalized where the layer is spectral)."""
    p = f"{name}.layers_0"
    lin = lambda n, t: ops.linear(t, W[n], S[n.rsplit(".", 1)[0] + ".bias"])
    b, s, d = x.shape
    hd = d // heads
    h = layer_norm(x, S[f"{p}.norm1.weight"], S[f"{p}.norm1.bias"])
    qkv = lin(f"{p}.self_attn.qkv_proj.weight", h).reshape(b, s, heads, 3 * hd).transpose(1, 2)
    q, k, v = qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]
    a = attention(ops, q, k, v, 1.0 / math.sqrt(hd)).transpose(1, 2).reshape(b, s, d)
    x = x + lin(f"{p}.self_attn.o_proj.weight", a)
    h = layer_norm(x, S[f"{p}.norm2.weight"], S[f"{p}.norm2.bias"])
    x = x + lin(f"{p}.linear2.weight", F.relu(lin(f"{p}.linear1.weight", h)))
    return layer_norm(x, S[f"{name}.norm.weight"], S[f"{name}.norm.bias"])


def rrm_linears(name):
    p = f"{name}.layers_0"
    return [f"{p}.self_attn.qkv_proj", f"{p}.self_attn.o_proj", f"{p}.linear1", f"{p}.linear2"]


def self_attention(ops, x, w_theta, w_phi, w_g, w_o, gamma):
    """SA-GAN attention over an NCHW map: q from theta, k and v from phi and
    g max-pooled 2x2, no 1/sqrt(d) scale, residual through gamma."""
    b, c, h, w = x.shape
    q = ops.conv(x, w_theta).flatten(2).transpose(1, 2)
    k = F.max_pool2d(ops.conv(x, w_phi), 2).flatten(2).transpose(1, 2)
    v = F.max_pool2d(ops.conv(x, w_g), 2).flatten(2).transpose(1, 2)
    o = attention(ops, q, k, v, 1.0).transpose(1, 2).reshape(b, c // 2, h, w)
    return gamma * ops.conv(o, w_o) + x


def _run(fn, *args, recompute: bool):
    return checkpoint(fn, *args, use_reentrant=False) if recompute else fn(*args)


# ----------------------------------------------------------------------------
# generator

def _batch_norm(x, S, name, train, eps):
    """(mean, inv_std) per channel: the batch's (biased variance) in train
    mode, the running statistics otherwise."""
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = (x * x).mean(dim=(0, 2, 3)) - mean * mean
    else:
        mean, var = S[f"{name}.mean"], S[f"{name}.var"]
    return mean, 1.0 / torch.sqrt(var + eps)


def _ccbn(ops, S, W, name, x, cond, train, eps):
    gain = 1.0 + ops.linear(cond, W[f"{name}.gain"])
    bias = ops.linear(cond, W[f"{name}.bias"])
    mean, inv = _batch_norm(x, S, name, train, eps)
    return (x - mean[:, None, None]) * inv[:, None, None] * gain[:, :, None, None] \
        + bias[:, :, None, None]


def _gblock(ops, S, W, name, cin, cout, up, train, eps, x, cond):
    conv = lambda n, t: ops.conv(t, W[f"{name}.{n}"], S[f"{name}.{n}.bias"])
    h = conv("conv1", F.relu(_ccbn(ops, S, W, f"{name}.bn1", x, cond, train, eps)))
    h = F.relu(_ccbn(ops, S, W, f"{name}.bn2", h, cond, train, eps))
    if cin != cout:
        x = x[:, :cout]
    if up:
        h = F.interpolate(h, scale_factor=2, mode="nearest")
        x = F.interpolate(x, scale_factor=2, mode="nearest")
    h = conv("conv2", h)
    h = conv("conv3", F.relu(_ccbn(ops, S, W, f"{name}.bn3", h, cond, train, eps)))
    h = conv("conv4", F.relu(_ccbn(ops, S, W, f"{name}.bn4", h, cond, train, eps)))
    return h + x


def g_sn_names(cfg):
    names = ["linear"] + (["linear_f"] if cfg["RRM_prx_G"] else [])
    for kind, name, _ in g_layout(cfg):
        if kind == "sa":
            names += [f"{name}.{c}" for c in ("theta", "phi", "g", "o")]
        else:
            for k in range(1, 5):
                names += [f"{name}.bn{k}.gain", f"{name}.bn{k}.bias", f"{name}.conv{k}"]
    return names + ["output_conv"]


def generator(cfg, S, z, y, rdof, ops: Ops, train: bool, recompute: bool = False):
    """G(z, y, rdof) -> (B, H, W, 1) in [-1, 1], in float32. ``train``: batch
    statistics and the spectral vectors advanced in ``S``; otherwise the
    running statistics and ``S`` unchanged. ``recompute`` checkpoints each
    block, so that a backward at full batch fits in memory."""
    es, eps = cfg["n_classes"], cfg["SN_eps"]
    W = sn_weights(S, g_sn_names(cfg), eps, update=train)
    y_emb = S["shared.weight"][y]
    if cfg["RRM_prx_G"]:
        y_emb = ops.linear(torch.cat([y_emb, rdof], -1), W["linear_f"], S["linear_f.bias"])
        for n in rrm_linears("RR_G"):
            W[f"{n}.weight"] = S[f"{n}.weight"]
        y_emb = rrm(ops, S, W, "RR_G", y_emb.reshape(-1, es, 128), cfg["n_head_G"])
        y_emb = y_emb.reshape(-1, 128)
    cond = torch.cat([y_emb, z], -1)
    top = g_top(cfg)
    h = ops.linear(cond, W["linear"], S["linear.bias"]).reshape(
        z.shape[0], top, 4, 4 * cfg["H_base"])
    bn_eps = cfg["BN_eps"]
    for kind, name, args in g_layout(cfg):
        if kind == "sa":
            fn = lambda t, n=name: self_attention(ops, t, W[f"{n}.theta"], W[f"{n}.phi"],
                                                  W[f"{n}.g"], W[f"{n}.o"], S[f"{n}.gamma"])
            h = _run(fn, h, recompute=recompute)
        else:
            cin, cout, up = args
            fn = lambda t, c, n=name, a=args: _gblock(ops, S, W, n, *a, train, bn_eps, t, c)
            h = _run(fn, h, cond, recompute=recompute)

    def tail(t):
        mean, inv = _batch_norm(t, S, "output_bn", train, 1e-5)
        t = (t - mean[:, None, None]) * inv[:, None, None] * S["output_bn.gain"][:, None, None] \
            + S["output_bn.bias"][:, None, None]
        return torch.tanh(ops.conv(F.relu(t), W["output_conv"], S["output_conv.bias"]))

    return _run(tail, h, recompute=recompute).permute(0, 2, 3, 1)


def postprocess(imgs, threshold=-0.26):
    """The deployment contract: values at or below ``threshold`` to -1, to
    ADU in [0, 255], rows 3..H-3, channel dropped."""
    imgs = torch.where(imgs > threshold, imgs, torch.full_like(imgs, -1.0))
    adu = torch.clamp(torch.pow(256.0, imgs * 0.5 + 0.5) - 1.0, 0.0, 255.0)
    return adu[:, 3:-3, :, 0]


# ----------------------------------------------------------------------------
# discriminator

def _dblock(ops, S, W, name, cin, cout, pre, down, x):
    conv = lambda n, t: ops.conv(t, W[f"{name}.{n}"], S[f"{name}.{n}.bias"])
    h = F.relu(x) if pre else x
    h = conv("conv1", h)
    h = conv("conv2", F.relu(h))
    h = F.relu(conv("conv3", F.relu(h)))
    sc = x
    if down:
        h = F.avg_pool2d(h, 2)
        sc = F.avg_pool2d(sc, 2)
    h = conv("conv4", h)
    if cin != cout:
        sc = torch.cat([sc, conv("conv_sc", sc)], 1)
    return h + sc


def d_sn_names(cfg):
    names = ["input_conv"]
    for kind, name, args in d_layout(cfg):
        if kind == "sa":
            names += [f"{name}.{c}" for c in ("theta", "phi", "g", "o")]
        else:
            names += [f"{name}.conv{k}" for k in range(1, 5)]
            if args[0] != args[1]:
                names.append(f"{name}.conv_sc")
    return names + ["linear0", "embed", "linear1"] + rrm_linears("RR_D")


def discriminator(cfg, S, x, y, ops: Ops, recompute: bool = False):
    """D(x, y) in train mode (the spectral vectors advance in ``S``) ->
    (proxy (B, hyper), embed (B, hyper), score (B,)), float32."""
    es, eps = cfg["n_classes"], cfg["SN_eps"]
    W = sn_weights(S, d_sn_names(cfg), eps, update=True)
    h = ops.conv(x.permute(0, 3, 1, 2), W["input_conv"], S["input_conv.bias"])
    for kind, name, args in d_layout(cfg):
        if kind == "sa":
            fn = lambda t, n=name: self_attention(ops, t, W[f"{n}.theta"], W[f"{n}.phi"],
                                                  W[f"{n}.g"], W[f"{n}.o"], S[f"{n}.gamma"])
        else:
            fn = lambda t, n=name, a=args: _dblock(ops, S, W, n, *a, t)
        h = _run(fn, h, recompute=recompute)
    h = torch.sum(F.relu(h), dim=(2, 3))
    score = ops.linear(h, W["linear0"], S["linear0.bias"]).squeeze(-1)
    proxy = W["embed"][y]
    for n in rrm_linears("RR_D"):
        W[f"{n}.weight"] = W.pop(n)
    r = rrm(ops, S, W, "RR_D", h.reshape(-1, es, h.shape[-1]), 4).reshape(h.shape)
    embed = layer_norm(ops.linear(r, W["linear1"], S["linear1.bias"]),
                       S["norm.weight"], S["norm.bias"])
    proxy = proxy / torch.clamp(proxy.norm(dim=-1, keepdim=True), min=1e-12)
    embed = embed / torch.clamp(embed.norm(dim=-1, keepdim=True), min=1e-12)
    return proxy, embed, score
