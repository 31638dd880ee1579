"""Architecture tables for BigGAN-deep style G/D stacks (the port's copy of
``ieagan_tpu/models/arch.py``).

Channel/upsample/attention schedules per output resolution, matching the
reference tables (reference: model.py:74-136 G_arch, model.py:561-621 D_arch)
including the 96-px special case. Widths are multiples of ``ch``
(G_ch/D_ch=32 in the flagship config -> top width 512).
"""

from __future__ import annotations


def _attn_set(attention: str) -> set[int]:
    return {int(item) for item in str(attention).split("_")}


def g_arch(ch: int, attention: str) -> dict:
    att = _attn_set(attention)
    tables = {
        512: dict(in_mul=[16, 16, 8, 8, 4, 2, 1], out_mul=[16, 8, 8, 4, 2, 1, 1],
                  upsample=[True] * 7, resolution=[8, 16, 32, 64, 128, 256, 512]),
        256: dict(in_mul=[16, 16, 8, 8, 4, 2], out_mul=[16, 8, 8, 4, 2, 1],
                  upsample=[True] * 6, resolution=[8, 16, 32, 64, 128, 256]),
        128: dict(in_mul=[16, 16, 8, 4, 2], out_mul=[16, 8, 4, 2, 1],
                  upsample=[True] * 5, resolution=[8, 16, 32, 64, 128]),
        96: dict(in_mul=[16, 16, 8, 4], out_mul=[16, 8, 4, 2],
                 upsample=[True] * 4, resolution=[12, 24, 48, 96]),
        64: dict(in_mul=[16, 16, 8, 4], out_mul=[16, 8, 4, 2],
                 upsample=[True] * 4, resolution=[8, 16, 32, 64]),
        32: dict(in_mul=[4, 4, 4], out_mul=[4, 4, 4],
                 upsample=[True] * 3, resolution=[8, 16, 32]),
    }
    arch = {}
    for res, t in tables.items():
        arch[res] = {
            "in_channels": [ch * m for m in t["in_mul"]],
            "out_channels": [ch * m for m in t["out_mul"]],
            "upsample": t["upsample"],
            "resolution": t["resolution"],
            # reference 96-table quirk: keys 12*2^i, membership tested on 6*2^i
            "attention": ({12 * 2 ** i: (6 * 2 ** i in att) for i in range(4)}
                          if res == 96 else
                          {r: (r in att) for r in t["resolution"]}),
        }
    return arch


def d_arch(ch: int, attention: str) -> dict:
    att = _attn_set(attention)
    tables = {
        512: dict(in_mul=[1, 1, 2, 4, 8, 8, 16], out_mul=[1, 2, 4, 8, 8, 16, 16],
                  downsample=[True] * 7 + [False],
                  resolution=[256, 128, 64, 32, 16, 8, 4, 4]),
        256: dict(in_mul=[1, 2, 4, 8, 8, 16], out_mul=[2, 4, 8, 8, 16, 16],
                  downsample=[True] * 6 + [False],
                  resolution=[128, 64, 32, 16, 8, 4, 4]),
        128: dict(in_mul=[1, 2, 4, 8, 16], out_mul=[2, 4, 8, 16, 16],
                  downsample=[True] * 5 + [False],
                  resolution=[64, 32, 16, 8, 4, 4]),
        64: dict(in_mul=[1, 2, 4, 8], out_mul=[2, 4, 8, 16],
                 downsample=[True] * 4 + [False],
                 resolution=[32, 16, 8, 4, 4]),
        32: dict(in_mul=[4, 4, 4], out_mul=[4, 4, 4],
                 downsample=[True, True, False, False],
                 resolution=[16, 16, 16, 16]),
    }
    arch = {}
    for res, t in tables.items():
        arch[res] = {
            "in_channels": [ch * m for m in t["in_mul"]],
            "out_channels": [ch * m for m in t["out_mul"]],
            "downsample": t["downsample"],
            "resolution": t["resolution"],
            "attention": {r: (r in att) for r in set(t["resolution"])},
        }
    return arch
