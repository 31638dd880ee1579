"""The port's fused attention forward (B1) against the JAX package's Pallas
kernel, run through the Pallas interpreter on the CPU.

On the CPU the port's wrapper computes the kernel's plain version; the CUDA
kernel itself is held against that plain version on the card by
``chip_smoke.py``. Inputs come from ``np.random.default_rng`` and reach both
frameworks as the same numpy arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ieagan_tpu.ops.attention import dot_softmax_attention as jax_attention
from ieagan_tpu.ops.pallas.flash_attention import _fwd, _pick_tq, flash_attention
from ieagan_torch.kernels import build
from ieagan_torch.kernels import flash_attention as port_kernel
from ieagan_torch.kernels.flash_attention import attention_fwd, attention_fwd_plain
from ieagan_torch.ops.attention import dot_softmax_attention
from tests.test_pallas import CASES
from tests.test_torch_eval import few_torch_threads  # noqa: F401 (autouse)

SITES = [
    # (B, Lq, Lkv, dk, dv, scale)
    (8, 40, 40, 64, 64, 0.125),               # RR_G, 4 events x 2 heads
    (4, 40, 40, 128, 128, 128 ** -0.5),       # RR_D, 4 heads of 128
    (1, 3072, 768, 32, 128, 1.0),             # D image attention, flagship widths
]


def _qkv(b, lq, lkv, dk, dv, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, lq, dk)).astype(dtype),
            rng.standard_normal((b, lkv, dk)).astype(dtype),
            rng.standard_normal((b, lkv, dv)).astype(dtype))


@pytest.mark.parametrize("b,lq,lkv,dk,dv,scale", CASES + SITES)
def test_plain_matches_pallas_kernel(b, lq, lkv, dk, dv, scale):
    """o and lse of the port's B1 against the Pallas forward kernel. Both
    sides compute in f32 and differ only in summation order: 2e-5, the bound
    tests/test_pallas.py holds the Pallas kernel to against XLA."""
    q, k, v = _qkv(b, lq, lkv, dk, dv, seed=lq + dk)
    o_want = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             scale=scale, interpret=True)
    _, lse_want = _fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                       _pick_tq(lq), True)
    o, lse = attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), scale)
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    assert o.shape == (b, lq, dv) and lse.shape == (b, lq)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_want), rtol=2e-5, atol=2e-5)


def test_plain_bfloat16_matches_pallas_kernel():
    """bf16 inputs: o in bf16, lse in f32. Both kernels compute in f32 from
    the same bf16 inputs, so only the final rounding of o to bf16 (2**-8
    relative) can differ: 1e-2."""
    q, k, v = _qkv(2, 64, 16, 16, 32, seed=5)
    qb, kb, vb = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v))
    o_want, lse_want = _fwd(qb, kb, vb, 1.0, _pick_tq(64), True)
    tb = [torch.tensor(np.asarray(t.astype(jnp.float32))).to(torch.bfloat16)
          for t in (qb, kb, vb)]
    o, lse = attention_fwd(*tb, 1.0)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(o.float().numpy(), np.asarray(o_want, np.float32),
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_dot_softmax_attention_matches_jax(fused):
    """Leading (batch, head) axes, the RRM's layout. 2e-5: f32 both sides."""
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((2, 2, 40, 64)).astype(np.float32) for _ in range(3))
    want = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         scale=0.125)
    got = dot_softmax_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), scale=0.125, fused=fused)
    assert got.shape == (2, 2, 40, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_plain_version_of_kernel_is_exact_softmax():
    """attention_fwd_plain is the reference the card holds the kernel to:
    check it against a float64 softmax. 1e-6: f32 rounding only."""
    q, k, v = _qkv(3, 24, 12, 8, 8, seed=2)
    o, lse = attention_fwd_plain(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), 0.5)
    s = np.einsum("bqd,bkd->bqk", q.astype(np.float64), k.astype(np.float64)) * 0.5
    lse_want = np.log(np.exp(s).sum(-1))
    o_want = np.einsum("bqk,bkd->bqd", np.exp(s - lse_want[..., None]), v)
    np.testing.assert_allclose(o.numpy(), o_want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), lse_want, rtol=1e-6, atol=1e-6)


def test_cuda_tensors_go_to_the_kernel_and_never_fall_back(monkeypatch):
    """A CUDA tensor takes the kernel's branch: without a CUDA toolchain that
    raises, instead of computing the plain version. Fake CUDA tensors stand
    in for real ones on a machine without a card."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(port_kernel, "_LIB", None)
    before = attention_fwd.launches
    with FakeTensorMode():
        q = torch.empty(2, 40, 64, device="cuda")
        with pytest.raises(RuntimeError, match="nvcc"):
            attention_fwd(q, q, q, 0.125)
        with pytest.raises(RuntimeError, match="nvcc"):
            dot_softmax_attention(q, q, q, 0.125, fused=True)
    assert attention_fwd.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    with FakeTensorMode():
        q = torch.empty(2, 40, 64, device="cuda")
        with pytest.raises(TypeError):
            attention_fwd(q.half(), q.half(), q.half(), 1.0)
        wide = torch.empty(2, 40, 512, device="cuda")
        with pytest.raises(ValueError, match="dk, dv <= 256"):
            attention_fwd(wide, wide, wide, 1.0)
        with pytest.raises(ValueError, match="contiguous"):
            t = q.transpose(0, 1)
            attention_fwd(t, t, t, 1.0)
    with pytest.raises(ValueError, match="disagree"):
        attention_fwd(torch.zeros(2, 4, 8), torch.zeros(2, 5, 8), torch.zeros(2, 4, 8), 1.0)
    with pytest.raises(ValueError, match="empty"):
        attention_fwd(torch.zeros(2, 0, 8), torch.zeros(2, 4, 8), torch.zeros(2, 4, 8), 1.0)
