"""The port's fused attention backward (B2) and the autograd function that
joins it to B1, against the JAX package's Pallas backward kernel run through
the Pallas interpreter on the CPU.

On the CPU the port's wrappers compute their plain versions; the CUDA kernel
itself is held against its plain version on the card by ``chip_smoke.py``.
Inputs come from ``np.random.default_rng`` and reach both frameworks as the
same numpy arrays.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ieagan_tpu.ops.pallas.flash_attention import _bwd, _fwd, _pick_tq
from ieagan_torch.kernels import build
from ieagan_torch.kernels import flash_attention as port_kernel
from ieagan_torch.kernels.flash_attention import (
    FlashAttention, attention_bwd, attention_bwd_plain, attention_fwd)
from ieagan_torch.models.generator import Generator
from ieagan_torch.ops.attention import dot_softmax_attention
from tests.helpers import tiny_config
from tests.test_pallas import CASES
from tests.test_torch_eval import few_torch_threads  # noqa: F401 (autouse)

SITES = [
    # (B, Lq, Lkv, dk, dv, scale): the train step's sites at a small batch
    (2, 40, 40, 64, 64, 0.125),               # RR_G, 1 event x 2 heads
    (4, 40, 40, 128, 128, 128 ** -0.5),       # RR_D, 1 event x 4 heads of 128
    (1, 3072, 768, 32, 128, 1.0),             # D image attention, flagship widths
]


def _inputs(b, lq, lkv, dk, dv, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(dtype) for s in
                 ((b, lq, dk), (b, lkv, dk), (b, lkv, dv), (b, lq, dv)))


def _pallas_bwd(q, k, v, do, scale):
    """o, lse from the Pallas forward, then dq, dk, dv from the Pallas
    backward, all in interpret mode."""
    tq = _pick_tq(q.shape[1])
    q, k, v, do = (jnp.asarray(t) for t in (q, k, v, do))
    o, lse = _fwd(q, k, v, scale, tq, True)
    grads = _bwd(scale, tq, True, (q, k, v, o, lse), do)
    return o, lse, grads


@pytest.mark.parametrize("b,lq,lkv,dk,dv,scale", CASES + SITES)
def test_plain_matches_pallas_backward(b, lq, lkv, dk, dv, scale):
    """dq, dk, dv of the port's B2 against the Pallas backward kernel on the
    same o and lse. Both recompute p in f32 and differ only in summation
    order: 2e-4, the bound tests/test_pallas.py holds the Pallas gradients to
    against XLA's."""
    q, k, v, do = _inputs(b, lq, lkv, dk, dv, seed=lq + dv)
    o, lse, want = _pallas_bwd(q, k, v, do, scale)
    got = attention_bwd(*(torch.from_numpy(t) for t in (q, k, v)),
                        torch.tensor(np.asarray(o)), torch.tensor(np.asarray(lse)),
                        torch.from_numpy(do), scale)
    for g, w, shape in zip(got, want, (q.shape, k.shape, v.shape)):
        assert g.dtype == torch.float32 and tuple(g.shape) == shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4)


def test_plain_bfloat16_matches_pallas_backward():
    """bf16 inputs: both kernels compute in f32 from the same bf16 inputs and
    round dq, dk, dv to bf16 at the end; the bf16 o and dO enter delta. One
    bf16 ulp of the result (2**-8 relative) plus f32 order: 2e-2."""
    q, k, v, do = _inputs(2, 64, 16, 16, 32, seed=5)
    qb, kb, vb, dob = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v, do))
    tq = _pick_tq(64)
    o, lse = _fwd(qb, kb, vb, 1.0, tq, True)
    want = _bwd(1.0, tq, True, (qb, kb, vb, o, lse), dob)
    to_torch = lambda t: torch.tensor(np.asarray(t.astype(jnp.float32))).to(torch.bfloat16)
    got = attention_bwd(to_torch(qb), to_torch(kb), to_torch(vb), to_torch(o),
                        torch.tensor(np.asarray(lse)), to_torch(dob), 1.0)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   rtol=2e-2, atol=2e-2)


def test_plain_backward_is_exact_softmax_gradient():
    """attention_bwd_plain is the reference the card holds the kernel to:
    check it against autograd of a float64 softmax attention. 1e-5: f32
    rounding only."""
    q, k, v, do = _inputs(3, 24, 12, 8, 8, seed=2)
    q64, k64, v64 = (torch.tensor(t, dtype=torch.float64, requires_grad=True)
                     for t in (q, k, v))
    o64 = torch.softmax(q64 @ k64.transpose(1, 2) * 0.5, dim=-1) @ v64
    want = torch.autograd.grad(o64, (q64, k64, v64), torch.tensor(do, dtype=torch.float64))
    o, lse = attention_fwd(*(torch.from_numpy(t) for t in (q, k, v)), 0.5)
    got = attention_bwd_plain(*(torch.from_numpy(t) for t in (q, k, v)), o, lse,
                              torch.from_numpy(do), 0.5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,lq,lkv,dk,dv,scale", SITES[:2] + [CASES[3]])
def test_flash_attention_gradients_equal_plain_autograd(b, lq, lkv, dk, dv, scale):
    """FlashAttention (B1 forward, B2 backward) gives the output and the q,
    k, v gradients of autograd through the plain composition. 1e-5: f32,
    different order of the same sums."""
    arrays = _inputs(b, lq, lkv, dk, dv, seed=b + lq)
    grads = []
    for fused in (True, False):
        q, k, v = (torch.tensor(t, requires_grad=True) for t in arrays[:3])
        o = (FlashAttention.apply(q, k, v, scale) if fused
             else dot_softmax_attention(q, k, v, scale))
        o.backward(torch.from_numpy(arrays[3]))
        grads.append((o.detach(), q.grad, k.grad, v.grad))
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_attention_fwd_alone_raises_on_inputs_that_need_grad():
    """The kernel's output carries no gradient, so the bare wrapper refuses
    to cut a graph; under no_grad, or through FlashAttention, it runs."""
    q = torch.randn(2, 8, 4, requires_grad=True)
    with pytest.raises(RuntimeError, match="FlashAttention"):
        attention_fwd(q, q, q, 1.0)
    with torch.no_grad():
        attention_fwd(q, q, q, 1.0)
    assert FlashAttention.apply(q, q, q, 1.0).requires_grad


def test_fused_generator_backward_reaches_rrm_and_linear_f():
    """The fault the autograd function repairs: with the fused attention, a
    backward through the generator reaches RR_G's projections and
    linear_f, with the gradients of the plain-attention generator. Per leaf
    ||fused - plain|| / ||plain|| < 1e-5: the two attentions differ by f32
    rounding, which the batch norms downstream amplify elementwise (up to
    ~2e-4 relative on single entries) but not in norm. Leaves whose gradient
    is null in exact arithmetic (conv biases feeding batch norms, under 1e-5
    of the largest norm) must stay null."""
    cfg = tiny_config(RRM_prx_G=True, rdof_dim=4)
    rng = np.random.default_rng(3)
    z = torch.tensor(rng.standard_normal((8, cfg["dim_z"])).astype(np.float32))
    rdof = torch.tensor(rng.standard_normal((8, 4)).astype(np.float32))
    y = torch.arange(4).repeat(2)
    grads = {}
    for fused in (True, False):
        G = Generator.from_config(dict(cfg, use_pallas_attention=fused))
        G.reset_parameters(torch.Generator().manual_seed(0))
        G(z, y, rdof).square().sum().backward()
        grads[fused] = {n: p.grad for n, p in G.named_parameters()}
    for name in ("RR_G.layers_0.self_attn.qkv_proj.weight", "linear_f.weight",
                 "shared.weight"):
        assert grads[True][name] is not None and grads[True][name].abs().max() > 0, name
    norm = torch.linalg.vector_norm
    null = 1e-5 * max(norm(g) for g in grads[False].values())
    for name, want in grads[False].items():
        got = grads[True][name]
        if norm(want) < null:
            assert norm(got) < null, name
        else:
            assert norm(got - want) / norm(want) < 1e-5, (name, float(norm(got - want) / norm(want)))


def test_cuda_tensors_go_to_the_backward_kernel_and_never_fall_back(monkeypatch):
    """A CUDA tensor takes the kernels' branch: without a CUDA toolchain that
    raises, in the bare wrapper and in FlashAttention, instead of computing
    the plain version. Fake CUDA tensors stand in for real ones."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(port_kernel, "_LIB", None)
    monkeypatch.setattr(port_kernel, "_LIB_BWD", None)
    before = attention_bwd.launches
    with FakeTensorMode():
        q = torch.empty(2, 40, 64, device="cuda")
        lse = torch.empty(2, 40, device="cuda")
        with pytest.raises(RuntimeError, match="nvcc"):
            attention_bwd(q, q, q, q, lse, q, 0.125)
        with pytest.raises(RuntimeError, match="nvcc"):
            FlashAttention.apply(q, q, q, 0.125)
    assert attention_bwd.launches == before


def test_backward_wrapper_rejects_what_the_kernel_does_not_take():
    bwd = functools.partial(attention_bwd, scale=1.0)
    q = torch.zeros(2, 4, 8)
    with pytest.raises(ValueError, match="disagree"):
        bwd(q, q, q, q, torch.zeros(2, 5), q)
    with pytest.raises(ValueError, match="float32"):
        bwd(q, q, q, q, torch.zeros(2, 4, dtype=torch.float64), q)
    with FakeTensorMode():
        c = torch.empty(2, 40, 64, device="cuda")
        lse = torch.empty(2, 40, device="cuda")
        with pytest.raises(ValueError, match="contiguous"):
            t = torch.empty_strided((2, 40, 64), (64, 128, 1), device="cuda")
            bwd(c, c, c, c, lse, t)
        wide = torch.empty(2, 40, 512, device="cuda")
        with pytest.raises(ValueError, match="dk, dv <= 256"):
            bwd(wide, wide, wide, wide, lse, wide)
