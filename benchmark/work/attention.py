"""Attention's least work from its shapes, and the attention sites that a
configuration calls.

``fwd_work`` and ``bwd_work`` count what a fused attention must move and
compute at least: each input read once, each output written once, the
products of the forward (two) and of the backward (five, the scores
recomputed). ``sites`` lists, for a generator call or a train step of a
configuration, every attention the published model computes, by site, with
how many forward and backward passes take it. The work is counted from the
model, not from whichever kernel ran, so the share stays comparable when an
implementation changes.
"""

from __future__ import annotations


def fwd_work(b, lq, lkv, dk, dv, itemsize):
    """(bytes, FLOP) of softmax(q k^T) v: q, k, v read once, o and the f32
    row statistic written once; the two products."""
    nbytes = (b * lq * dk + b * lkv * dk + b * lkv * dv + b * lq * dv) * itemsize + b * lq * 4
    return nbytes, 2.0 * b * lq * lkv * (dk + dv)


def bwd_work(b, lq, lkv, dk, dv, itemsize):
    """(bytes, FLOP) of the backward: q, k, v, o, dO and the statistic read
    once, dq, dk, dv written once; the five products."""
    nbytes = (2 * (b * lq * dk + b * lkv * dk + b * lkv * dv) + 2 * b * lq * dv) * itemsize \
        + b * lq * 4
    return nbytes, 2.0 * b * lq * lkv * (3 * dk + 2 * dv)


def _attn_set(s):
    return {int(a) for a in str(s).split("_")}


def _sa_shape(cfg, images, channels, res_h):
    """(B, Lq, Lkv, dk, dv) of SA-GAN attention over a map of ``channels``
    at height ``res_h`` (width res_h * H_base); k and v pooled 2x2."""
    hw = res_h * res_h * cfg["H_base"]
    return (images, hw, hw // 4, channels // 8, channels // 2)


G_SA_CHANNELS = {8: 16, 16: 8, 32: 8, 64: 4, 128: 2, 256: 1}   # out_mul at 256
D_SA_CHANNELS = {128: 2, 64: 4, 32: 8, 16: 8, 8: 16, 4: 16}


def sites(cfg, kind: str, events: int):
    """[(site, (B, Lq, Lkv, dk, dv), forwards, backwards)] of one generator
    call (``kind="generate"``) or one train step (``kind="train"``) of
    ``events`` events under ``cfg`` (resolution 256)."""
    es = cfg["n_classes"]
    images = events * es
    out = []
    g_sa = [r for r in _attn_set(cfg["G_attn"]) if r in G_SA_CHANNELS]
    d_sa = [r for r in _attn_set(cfg["D_attn"]) if r in D_SA_CHANNELS]
    rr_g = (events * cfg["n_head_G"], es, es, 128 // cfg["n_head_G"], 128 // cfg["n_head_G"])
    d_top = 16 * cfg["D_ch"]
    rr_d = (events * 4, es, es, d_top // 4, d_top // 4)
    if kind == "generate":
        if cfg["RRM_prx_G"]:
            out.append(("RR_G", rr_g, 1, 0))
        for r in g_sa:
            out.append(("G_SA", _sa_shape(cfg, images, cfg["G_ch"] * G_SA_CHANNELS[r], r), 1, 0))
        return out
    # a step: G twice (D phase without gradient, G phase with), D three times
    # (fake and real passes in the D phase, the fakes' pass in the G phase);
    # the fake pass of the D phase reads no gradient through D's embedding
    # head, so RR_D runs backward twice, D's image attention three times
    if cfg["RRM_prx_G"]:
        out.append(("RR_G", rr_g, 2, 1))
    for r in g_sa:
        out.append(("G_SA", _sa_shape(cfg, images, cfg["G_ch"] * G_SA_CHANNELS[r], r), 2, 1))
    for r in d_sa:
        out.append(("D_SA", _sa_shape(cfg, images, cfg["D_ch"] * D_SA_CHANNELS[r], r), 3, 3))
    out.append(("RR_D", rr_d, 3, 2))
    return out


def least_seconds(site_list, itemsize, peak_flops, peak_bytes):
    """The least time of every pass over ``site_list``: per pass the larger
    of its FLOP over the peak and its bytes over the bandwidth."""
    total = 0.0
    for _, shape, n_fwd, n_bwd in site_list:
        for n, work in ((n_fwd, fwd_work), (n_bwd, bwd_work)):
            if n:
                nbytes, flops = work(*shape, itemsize)
                total += n * max(flops / peak_flops, nbytes / peak_bytes)
    return total
