"""The numbers that decide ``correct``: the program's outputs against the
plain reference's, each a single worst case.

Generator calls (``tanh_gap``): both sides' ADU images are mapped back to
the generator's output scale, t = 2 log_256(ADU + 1) - 1 (a pixel cut by
the -0.26 threshold reads -1), and the largest |t_program - t_reference|
is taken over the pixels whose reference value lies more than ``margin``
from the threshold; at the threshold itself a rounding may cut a pixel on
one side only.

Train steps, per leaf (tensor) of G, D and G_ema, each gap of norms against
the reference's norm of that leaf or of the median leaf, whichever is
larger, for the first step's gradient as the optimiser got it (| |g_p| -
|g_r| |) and the parameters' change over the first steps (| |dp_p| - |dp_r|
|); per step, each loss's |p - r| / max(|r|, 1). A leaf whose reference
gradient is under a thousandth of the median leaf's moves by round-off alone
and is left out of both. ``traffic/train.py`` says which of these decide.
"""

from __future__ import annotations

import math

import torch

THRESHOLD = -0.26
LOG256 = math.log(256.0)


def adu_to_t(adu):
    return 2.0 * torch.log1p(adu.double()) / LOG256 - 1.0


def tanh_gap(adu_program, t_reference, margin: float):
    """(gap, pixels compared) of one call's (B, 250, W) ADU images against
    the reference's (B, 256, W, 1) output before the postprocess."""
    t_ref = t_reference[:, 3:-3, :, 0].double()
    t_ref_cut = torch.where(t_ref > THRESHOLD, t_ref, torch.full_like(t_ref, -1.0))
    keep = (t_ref - THRESHOLD).abs() > margin
    diff = (adu_to_t(adu_program.to(t_ref.device)) - t_ref_cut).abs()
    diff = torch.where(keep, diff, torch.zeros_like(diff))
    return float(diff.max()), int(keep.sum())


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def _median(values):
    values = sorted(values)
    return values[len(values) // 2] if values else 0.0


def leaf_gaps(program: dict, reference: dict, keep) -> dict:
    """{leaf: gap} of the norms of ``program`` against ``reference`` over
    the leaves in ``keep``; a gap that is not a number reads inf."""
    pn, rn = _norms({k: program[k] for k in keep}), _norms({k: reference[k] for k in keep})
    floor = _median(rn.values())
    out = {}
    for k in keep:
        gap = abs(pn[k] - rn[k]) / max(rn[k], floor, 1e-30)
        out[k] = gap if gap == gap else math.inf
    return out


def worst(gaps: dict) -> tuple[float, str]:
    """(largest gap, its leaf)."""
    if not gaps:
        return 0.0, ""
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def moving_leaves(ref_grads: dict) -> list:
    """The leaves whose reference gradient norm is at least a thousandth of
    the median leaf's."""
    norms = _norms(ref_grads)
    floor = 1e-3 * _median(norms.values())
    return [k for k, n in norms.items() if n >= floor]


def loss_gaps(program_steps: list, reference_steps: list) -> dict:
    """{"step <i> <loss>": gap} of each step's losses."""
    out = {}
    for i, (p, r) in enumerate(zip(program_steps, reference_steps)):
        for k, rv in r.items():
            gap = abs(p[k] - rv) / max(abs(rv), 1.0)
            out[f"step {i + 1} {k}"] = gap if gap == gap else math.inf
    return out


def median_gap(gaps: dict) -> float:
    """The median leaf's gap (a steadier reading beside the worst)."""
    return _median(gaps.values())
