"""Model FLOPs and attention sites of BigGAN-deep's generator from a
configuration's shapes (``reference/biggan_deep.py``'s layout), counted as
``model_flops`` counts IEA-GAN's: convolutions, linear maps, attention's
two products and the spectral norm's power-iteration step once per layer
and forward; element-wise work is not counted. The output conv counts its
``output_channels`` (3, RGB)."""

from __future__ import annotations

from benchmark.reference import biggan_deep as ref
from benchmark.work.model_flops import _sa, _sa_sn, _sn


def g_forward(cfg, images: int) -> float:
    """FLOPs of one forward of G over ``images`` latents."""
    b, cond = images, cfg["shared_dim"] + cfg["dim_z"]
    top = ref.top_channels(cfg)
    h, w = ref.BOTTOM, ref.BOTTOM * cfg["H_base"]
    total = 2 * b * cond * top * h * w + _sn(top * h * w, cond)
    for kind, _, args in ref.layout(cfg):
        if kind == "sa":
            total += _sa(b, args[0], h, w) + _sa_sn(args[0])
            continue
        cin, cout, up = args
        hid = cin // 4
        for c in (cin, hid, hid, hid):  # ccbn: gain and bias maps of cond
            total += 2 * (2 * b * cond * c + _sn(c, cond))
        total += 2 * b * cin * hid * h * w + _sn(hid, cin)
        if up:
            h, w = 2 * h, 2 * w
        total += 2 * (2 * b * hid * hid * 9 * h * w + _sn(hid, hid * 9))
        total += 2 * b * hid * cout * h * w + _sn(cout, hid)
    c, rgb = ref.last_channels(cfg), cfg["output_channels"]
    return float(total + 2 * b * c * rgb * 9 * h * w + _sn(rgb, c * 9))


def sites(cfg, images: int):
    """[("G_SA", (B, Lq, Lkv, dk, dv), 1, 0)] of each self-attention of a
    generator call of ``images`` images: q over the map, k and v pooled 2x2,
    dk = C / 8, dv = C / 2."""
    table = ref.TABLES[cfg["resolution"]]
    attn = {int(a) for a in str(cfg["G_attn"]).split("_")}
    out = []
    for res, mul in zip(table["resolution"], table["out_mul"]):
        if res in attn:
            c, hw = cfg["G_ch"] * mul, res * res * cfg["H_base"]
            out.append(("G_SA", (images, hw, hw // 4, c // 8, c // 2), 1, 0))
    return out
