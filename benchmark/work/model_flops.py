"""Model FLOPs of IEA-GAN from a configuration's shapes.

Counts the products the published model computes: convolutions, linear
maps, attention's two products, the spectral norm's power-iteration step
(once per forward of each layer), the losses' Gram matrices and the
orthogonal regulariser's two products per matrix. Element-wise work (norms,
activations, pooling, DiffAugment, Adam) is not counted, and nothing that a
program recomputes is: a backward pass counts twice its forward where the
weights take gradients and once where only the input does. The layer
widths come from the published architecture tables (``reference.model``).
"""

from __future__ import annotations

from benchmark.reference import model as ref


def _sn(o, k):
    """One power-iteration step and the singular value: u W, v W^T, v W^T u."""
    return 6 * o * k + 2 * o


def _rrm(n_seq, es, dim, ff, heads):
    tokens = n_seq * es
    hd = dim // heads
    return (2 * tokens * dim * 3 * dim + 2 * n_seq * heads * es * es * 2 * hd
            + 2 * tokens * dim * dim + 2 * 2 * tokens * dim * ff)


def _rrm_sn(dim, ff):
    return _sn(3 * dim, dim) + _sn(dim, dim) + _sn(ff, dim) + _sn(dim, ff)


def _sa(b, c, h, w):
    hw = h * w
    return (2 * b * hw * (2 * c * (c // 8) + c * (c // 2) + (c // 2) * c)
            + 2 * b * hw * (hw // 4) * (c // 8 + c // 2))


def _sa_sn(c):
    return 2 * _sn(c // 8, c) + _sn(c // 2, c) + _sn(c, c // 2)


def g_forward(cfg, images: int) -> float:
    """FLOPs of one forward of G over ``images`` latents."""
    es, cond = cfg["n_classes"], cfg["dim_z"]
    total, b = 0, images
    if cfg["RRM_prx_G"]:
        k = cfg["shared_dim"] + cfg["rdof_dim"]
        total += 2 * b * k * 128 + _sn(128, k)
        total += _rrm(b // es, es, 128, 128, cfg["n_head_G"])
        cond += 128
    else:
        cond += cfg["shared_dim"]
    top = ref.g_top(cfg)
    h, w = 4, 4 * cfg["H_base"]
    total += 2 * b * cond * top * h * w + _sn(top * h * w, cond)
    for kind, _, args in ref.g_layout(cfg):
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
    c = ref.g_last(cfg)
    return float(total + 2 * b * c * 9 * h * w + _sn(1, c * 9))


def d_forward(cfg, images: int) -> float:
    """FLOPs of one forward of D over ``images`` images."""
    es, b = cfg["n_classes"], images
    h, w = cfg["resolution"], cfg["resolution"] * cfg["H_base"]
    spec = ref.d_spec(cfg)
    ch0 = spec["input_conv.weight"][0][0]
    total = 2 * b * ch0 * 9 * h * w + _sn(ch0, 9)
    for kind, _, args in ref.d_layout(cfg):
        if kind == "sa":
            total += _sa(b, args[0], h, w) + _sa_sn(args[0])
            continue
        cin, cout, _, down = args
        hid = cout // 4
        total += 2 * b * cin * hid * h * w + _sn(hid, cin)
        total += 2 * (2 * b * hid * hid * 9 * h * w + _sn(hid, hid * 9))
        if down:
            h, w = h // 2, w // 2
        total += 2 * b * hid * cout * h * w + _sn(cout, hid)
        if cin != cout:
            total += 2 * b * cin * (cout - cin) * h * w + _sn(cout - cin, cin)
    top, hyper = ref.d_top(cfg), cfg["hypersphere_dim"]
    total += 2 * b * top + _sn(1, top)
    total += _sn(cfg["n_classes"], hyper)
    total += _rrm(b // es, es, top, 512, 4) + _rrm_sn(top, 512)
    total += 2 * b * top * hyper + _sn(hyper, top)
    return float(total)


def ortho(cfg) -> float:
    """The regulariser's W W^T and (W W^T) W over G's matrices."""
    total = 0
    for name, (shape, kind) in ref.g_spec(cfg).items():
        if kind == "weight" and len(shape) >= 2 and not name.startswith("shared."):
            o = shape[0]
            k = 1
            for s in shape[1:]:
                k *= s
            total += 4 * o * o * k
    return float(total)


def generate_call(cfg, events: int) -> float:
    """One generator call of ``events`` events."""
    return g_forward(cfg, events * cfg["n_classes"])


def train_step(cfg, events: int) -> float:
    """One train step of ``events`` events: the D phase's G forward, D's
    fake and real passes with their backward, the G phase's G forward and
    backward, D's pass and its backward to the input, the losses' Gram
    matrices and the regulariser."""
    b = events * cfg["n_classes"]
    g, d = g_forward(cfg, b), d_forward(cfg, b)
    gram = 2 * b * b * cfg["hypersphere_dim"]
    losses = 2 * gram + 4 * gram  # D phase: 2C, uniformity; G phase: 2C, IEA (2), uniformity
    return g + 2 * 3 * d + 3 * g + 2 * d + losses + ortho(cfg)
