"""Split-TF32, the f32 arithmetic of the tensor-core attention kernels (B1, B2),
emulated on the CPU.

The kernels take each f32 operand as big + small, both TF32 (10 mantissa
bits, rounded half away from zero), and each product as small·big +
big·small + big·big (``csrc/mma_tile.cuh``). A product of two TF32 values is
exact in f32, so an f32 matmul of the TF32 parts emulates one tensor-core
product. These tests show, at D's image-attention site (dk 32, dv 128,
scale 1, Lq 3072, Lkv 768; one image instead of 40), that attention built
from split-TF32 products is within ``chip_smoke.py``'s f32 tolerances of an
f64 truth, and that single-pass TF32 is not: the reason the kernels take
three products per f32 product. Inputs come from ``np.random.default_rng``.
Run as a script to print the margins:

    PYTHONPATH=. python tests/test_torch_split_tf32.py
"""

import numpy as np
import pytest
import torch

from chip_smoke import TOLERANCES

B, LQ, LKV, DK, DV, SCALE = 1, 3072, 768, 32, 128, 1.0


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32, half away from zero, on the int32 view: add half
    a TF32 ulp to the bit pattern, clear the low 13 bits (the kernels' split
    adds 0x1000 and lets the tensor cores drop the 13 bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32(x)
    return big, tf32(x - big)


def split_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    (a_big, a_small), (b_big, b_small) = split(a), split(b)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def single_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32(a) @ tf32(b)


def attention(q, k, v, mm):
    s = mm(q, k.transpose(-1, -2)) * SCALE
    lse = torch.logsumexp(s, dim=-1)
    o = mm(torch.exp(s - lse[..., None]), v)
    return o, lse


@pytest.fixture(scope="module")
def site():
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((B, LQ, DK), (B, LKV, DK), (B, LKV, DV)))
    truth = attention(q.double(), k.double(), v.double(), torch.matmul)
    return q, k, v, truth


def _within(got, want, tol):
    atol, rtol = tol
    err = (got.double() - want).abs()
    return bool((err <= atol + rtol * want.abs()).all()), float(err.max())


def test_tf32_rounds_half_away_from_zero():
    ulp = 2.0 ** -10  # TF32's ulp at 1
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4, 1 + 3 * ulp / 4, -7.25, 0.0])
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + ulp, -7.25, 0.0])
    np.testing.assert_array_equal(tf32(x).numpy(), want.numpy())
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(10_000).astype(np.float32))
    assert tf32(y).view(torch.int32).bitwise_and(0x1FFF).eq(0).all()
    assert float(((tf32(y) - y).abs() / y.abs()).max()) <= 2.0 ** -11


def test_split_represents_f32_to_22_bits():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(100_000).astype(np.float32))
    big, small = split(x)
    err = (big.double() + small.double() - x.double()).abs() / x.double().abs()
    assert float(err.max()) <= 2.0 ** -22
    assert float((big - x).abs().div(x.abs()).max()) <= 2.0 ** -11


@pytest.mark.parametrize("name", ["o", "lse"])
def test_split_tf32_attention_is_within_the_f32_tolerance(site, name):
    """Both products in split-TF32: o and lse within chip_smoke.py's f32
    TOLERANCES of the f64 truth."""
    q, k, v, truth = site
    got = attention(q, k, v, split_mm)
    ok, err = _within(got[name == "lse"], truth[name == "lse"], TOLERANCES["float32"][name])
    assert ok, f"{name}: max error {err:.3e}"


def test_single_pass_tf32_is_not(site):
    """One TF32 product per f32 product: each operand keeps ~2^-11, the
    scores (|s| ~ 25 at scale 1) move by ~1e-3 and o leaves the tolerance."""
    q, k, v, truth = site
    o, _ = attention(q, k, v, single_mm)
    ok, err = _within(o, truth[0], TOLERANCES["float32"]["o"])
    assert not ok and err > 10 * TOLERANCES["float32"]["o"][0], err


def main():
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((B, LQ, DK), (B, LKV, DK), (B, LKV, DV)))
    truth = attention(q.double(), k.double(), v.double(), torch.matmul)
    for label, mm in (("f32", torch.matmul), ("split-TF32", split_mm), ("TF32", single_mm)):
        for i, name in enumerate(("o", "lse")):
            atol, rtol = TOLERANCES["float32"][name]
            got, want = attention(q, k, v, mm)[i].double(), truth[i]
            err = (got - want).abs()
            print(f"{label:10s} {name:3s} max error {float(err.max()):.2e}, worst "
                  f"error / tolerance {float((err / (atol + rtol * want.abs())).max()):.3f}")


if __name__ == "__main__":
    main()
