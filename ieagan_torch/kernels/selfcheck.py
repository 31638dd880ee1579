"""Self-check of the fused attention kernels on the card: the twin of
``ieagan_tpu/ops/pallas/selfcheck.py::run_check``.

Forward and backward of ``FlashAttention`` (B1, B2) against the plain
composition (``dot_softmax_attention(fused=False)``, the twin of the JAX
package's ``_xla_attention``) at the model's attention sites, scored as that
module scores them: by Frobenius-relative error and by max error over the
reference's standard deviation. Elementwise bounds cannot express the
rounding scatter of long reductions (dq sums over Lkv = 768) in either
implementation; a masking or tiling fault gives errors of 0.1-1 in these
units, rounding ~1e-3.

    python -m ieagan_torch.kernels.selfcheck

needs a CUDA card; ``chip_smoke.py`` runs it after its kernel phases.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from ieagan_torch.kernels.flash_attention import FlashAttention
from ieagan_torch.ops.attention import dot_softmax_attention

# (name, B, Lq, Lkv, dk, dv, scale): the model's sites at flagship widths
# (G's and D's relational reasoning, D's proxy RRM with 4 heads of 256, D's
# image attention at 32x96, which PEGAN's G attention shares), and the JAX
# self-check's image-attention shape (D_ch = 16: dk 16, dv 64).
CASES = [
    ("rr_g_40x40", 8, 40, 40, 64, 64, 0.125),
    ("rr_d_40x40", 4, 40, 40, 128, 128, 128 ** -0.5),
    ("rr_dproxy_80x80", 4, 80, 80, 256, 256, 256 ** -0.5),
    ("d_sa_3072x768", 2, 3072, 768, 32, 128, 1.0),
    ("dattn_3072x768", 2, 3072, 768, 16, 64, 1.0),
]
# The JAX self-check's bounds: Frobenius-relative error, and max |error| in
# units of the reference's standard deviation.
BOUNDS = {torch.float32: (1e-2, 1e-1), torch.bfloat16: (2e-2, 1.5e-1)}


def normalized_errors(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """``(||got - want|| / ||want||, max |got - want| / std(want))`` in f64;
    the standard deviation is the population one, as ``np.std``."""
    a, b = got.detach().double(), want.detach().double()
    diff = a - b
    fro = float(diff.norm() / (b.norm() + 1e-12))
    max_over_std = float(diff.abs().max() / (b.std(correction=0) + 1e-12))
    return fro, max_over_std


def check_case(case, dtype, device) -> float:
    """One case: forward output and the gradients of ``sum(o * w)`` with
    respect to q, k and v, fused against plain. Returns the worst
    Frobenius-relative error; raises ``AssertionError`` past ``BOUNDS``."""
    name, b, lq, lkv, dk, dv, scale = case
    rtol, atol = BOUNDS[dtype]
    # a stable digest, not hash(): str hashes change from process to process
    rs = np.random.RandomState(zlib.crc32(name.encode()) % 2 ** 31)
    q, k, v, w = (torch.tensor(rs.randn(*shape), dtype=torch.float32).to(device, dtype)
                  for shape in ((b, lq, dk), (b, lkv, dk), (b, lkv, dv), (b, lq, dv)))

    def run(attend):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = attend(*leaves)
        grads = torch.autograd.grad((out.float() * w.float()).sum(), leaves)
        return (out, *grads)

    fused = run(lambda q, k, v: FlashAttention.apply(q, k, v, scale))
    plain = run(lambda q, k, v: dot_softmax_attention(q, k, v, scale=scale, fused=False))
    worst = 0.0
    for tag, got, want in zip(("out", "dq", "dk", "dv"), fused, plain):
        fro, max_over_std = normalized_errors(got, want)
        if not (fro <= rtol and max_over_std <= atol):
            raise AssertionError(
                f"fused vs plain attention mismatch: {name}/{tag} ({dtype}): "
                f"frobenius_rel={fro:.2e} (bound {rtol}), max_err/std={max_over_std:.2e} "
                f"(bound {atol})")
        worst = max(worst, fro)
    return worst


def run_check(dtype=torch.bfloat16) -> dict:
    """Every case of ``CASES`` on the card: ``{case name: worst
    Frobenius-relative error}``. Raises ``RuntimeError`` without a CUDA
    device (the check is of the compiled kernels) and ``AssertionError`` on
    a mismatch."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this check validates the compiled CUDA "
                           "attention kernels")
    return {case[0]: round(check_case(case, dtype, "cuda"), 8) for case in CASES}


def main():
    for dtype in (torch.float32, torch.bfloat16):
        print(f"attention kernel selfcheck [{dtype}] OK: {run_check(dtype)}")


if __name__ == "__main__":
    main()
