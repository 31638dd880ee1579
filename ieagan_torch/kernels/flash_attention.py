"""Fused attention (B1 forward, B2 backward): the CUDA kernels' wrappers, their
plain versions, and the autograd function that joins them.

``attention_fwd(q, k, v, scale)`` returns ``o = softmax(scale * q kᵀ) v`` and
the f32 row statistic ``lse = m + log(sum exp(s - m))`` over 3-D tensors
``q (B, Lq, dk)``, ``k (B, Lkv, dk)``, ``v (B, Lkv, dv)``. It is the twin of
``ieagan_tpu/ops/pallas/flash_attention.py::_fwd``: softmax statistics and
accumulation are f32, ``o`` takes the input type.

``attention_bwd(q, k, v, o, lse, do, scale)`` returns ``(dq, dk, dv)``, the
twin of ``_bwd``: it recomputes ``p = exp(scale * q kᵀ - lse)`` and
accumulates in f32; the gradients take the input type.

``FlashAttention.apply(q, k, v, scale[, span_name])`` is the differentiable
``o``: B1 forward, B2 backward, as ``_flash_attention_3d.defvjp`` joins them
in the JAX package. ``attention_fwd`` alone cuts the graph (the kernel
writes ``o`` through a pointer), so it raises when grad mode is on and an
input requires grad.

For CUDA tensors each wrapper launches its kernel (``csrc/attention_fwd.cu``,
``csrc/attention_bwd.cu``, built by ``kernels/build.py`` at first use) on the
current stream, or raises. For CPU tensors it computes its plain version, the
same function in plain PyTorch. Nothing falls back from the one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from ieagan_torch.core.spans import span
from ieagan_torch.kernels import build

MAX_HEAD_DIM = 256
# The kernels pad each head width up to one of PADDED_WIDTHS (zero columns
# change no product). Every pair of padded widths up to 128 has an instance of
# its own (``IEAGAN_ATTENTION_WIDTHS`` in ``csrc/mma_tile.cuh``); a pair with a
# width past 128 pads both widths to 256 and takes the one (256, 256)
# instance (D's proxy RRM). So any dk, dv <= 256 runs.
PADDED_WIDTHS = (32, 64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LIB: ctypes.CDLL | None = None
_LIB_BWD: ctypes.CDLL | None = None


def attention_fwd_plain(q, k, v, scale: float):
    """Plain PyTorch B1: f32 scores, f32 softmax, f32 product, ``o`` cast to
    the type of ``q``. Used for CPU tensors and as the kernel's reference."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.matmul(p, v.float())
    return o.to(q.dtype), lse


def attention_bwd_plain(q, k, v, o, lse, do, scale: float):
    """Plain PyTorch B2: recompute ``p`` from ``lse``, products and
    statistics in f32 (f64 for f64 inputs), gradients cast to the input
    types. Used for CPU tensors and as the kernel's reference, which
    ``chip_smoke.py`` takes in f64: at D's image-attention site (scale 1,
    |s| ~ 25) dS = p (dP - delta) multiplies the rounding of the score s by
    |dP - delta|, and the function in f32 is further from f64 than the
    tensor-core kernel is."""
    acc = torch.promote_types(q.dtype, torch.float32)
    qf, kf, vf, dof = q.to(acc), k.to(acc), v.to(acc), do.to(acc)
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale - lse.to(acc)[..., None])
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    delta = (dof * o.to(acc)).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _library(name: str, fn: str, n_ptrs: int, n_ints: int) -> ctypes.CDLL:
    """A kernel's library, built at first use, with its C signature set:
    ``n_ptrs`` pointers, ``n_ints`` ints, scale, dtype, device, stream."""
    lib = build.load(name)
    entry = getattr(lib, fn)
    entry.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                      + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    entry.restype = ctypes.c_int
    lib.ieagan_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ieagan_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _kernel_library() -> ctypes.CDLL:
    """B1's library."""
    global _LIB
    if _LIB is None:
        _LIB = _library("attention_fwd", "ieagan_attention_fwd", 5, 5)
    return _LIB


def _bwd_kernel_library() -> ctypes.CDLL:
    """B2's library."""
    global _LIB_BWD
    if _LIB_BWD is None:
        _LIB_BWD = _library("attention_bwd", "ieagan_attention_bwd", 10, 5)
    return _LIB_BWD


def padded_width(d: int) -> int:
    """The width a head of width ``d`` is padded to in the kernels."""
    for width in PADDED_WIDTHS:
        if d <= width:
            return width
    raise ValueError(f"the attention kernel takes dk, dv <= {MAX_HEAD_DIM}; got {d}")


def padded_pair(dk: int, dv: int) -> tuple[int, int]:
    """The kernel instance ``(padded dk, padded dv)`` that a pair of head
    widths runs in: both 256 if either is past 128."""
    pair = padded_width(dk), padded_width(dv)
    return (MAX_HEAD_DIM, MAX_HEAD_DIM) if max(pair) > 128 else pair


def _check(q, k, v):
    if not (q.ndim == k.ndim == v.ndim == 3):
        raise ValueError(f"attention_fwd takes 3-D q, k, v; got {q.shape}, "
                         f"{k.shape}, {v.shape}")
    b, lq, dk = q.shape
    if k.shape[0] != b or v.shape[0] != b or k.shape[2] != dk \
            or v.shape[1] != k.shape[1]:
        raise ValueError(f"attention_fwd shapes disagree: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if min(b, lq, k.shape[1], dk, v.shape[2]) == 0:
        raise ValueError("attention_fwd takes no empty axis")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k and v must have one type")


def _check_kernel_inputs(*tensors):
    """What the kernels take: CUDA, f32 or bf16, head widths <= 256,
    contiguous."""
    q = tensors[0]
    if q.device.type != "cuda":
        raise ValueError(f"the attention kernels run on CUDA or CPU, not {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the attention kernel takes float32 or bfloat16, not {q.dtype}")
    dk, dv = q.shape[-1], tensors[2].shape[-1]
    if dk > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise ValueError(f"the attention kernel takes dk, dv <= {MAX_HEAD_DIM}; "
                         f"got dk={dk}, dv={dv}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the attention kernel takes contiguous tensors")


def attention_fwd(q, k, v, scale: float):
    """B1 forward: ``(o (B, Lq, dv) in q's type, lse (B, Lq) f32)``.

    CUDA tensors go to the kernel, which takes f32 or bf16, ``dk, dv <= 256``
    (padded as ``padded_pair`` says) and contiguous tensors, and raises on
    anything else. CPU tensors go to ``attention_fwd_plain``. ``attention_fwd.launches`` counts kernel
    launches. It raises when grad mode is on and an input requires grad:
    the kernel's output carries no gradient, so differentiate through
    ``FlashAttention`` instead."""
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("attention_fwd does not carry gradients; call "
                           "FlashAttention.apply for a differentiable attention")
    if q.device.type == "cpu":
        return attention_fwd_plain(q, k, v, scale)
    _check_kernel_inputs(q, k, v)
    b, lq, dk = q.shape
    lkv, dv = v.shape[1], v.shape[2]
    o = torch.empty((b, lq, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, lq), dtype=torch.float32, device=q.device)
    lib = _kernel_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.ieagan_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, lq, lkv, dk, dv, float(scale), _DTYPE_CODES[q.dtype],
        q.device.index, stream)
    if err != 0:
        raise RuntimeError("attention kernel launch failed: "
                           + lib.ieagan_cuda_error_string(err).decode())
    attention_fwd.launches += 1
    return o, lse


attention_fwd.launches = 0


def attention_bwd(q, k, v, o, lse, do, scale: float):
    """B2 backward: ``(dq, dk, dv)`` in the types of ``q, k, v``, from the
    forward's inputs, its output ``o`` and f32 statistic ``lse (B, Lq)``, and
    the output gradient ``do (B, Lq, dv)``.

    CUDA tensors go to the kernel, which takes what B1 takes (f32 or bf16,
    ``dk, dv <= 256``, contiguous) and raises on anything else. CPU tensors go
    to ``attention_bwd_plain``. ``attention_bwd.launches`` counts kernel
    launches (one per call: two CUDA kernels back to back, the delta pass
    and the dK/dV and dQ pass)."""
    _check(q, k, v)
    b, lq, dk = q.shape
    lkv, dv = v.shape[1], v.shape[2]
    if tuple(o.shape) != (b, lq, dv) or tuple(do.shape) != (b, lq, dv) \
            or tuple(lse.shape) != (b, lq):
        raise ValueError(f"attention_bwd shapes disagree: q {tuple(q.shape)}, "
                         f"v {tuple(v.shape)}, o {tuple(o.shape)}, "
                         f"lse {tuple(lse.shape)}, do {tuple(do.shape)}")
    if not (o.device == do.device == lse.device == q.device):
        raise ValueError("all attention_bwd inputs must lie on one device")
    if not (o.dtype == do.dtype == q.dtype) or lse.dtype != torch.float32:
        raise ValueError("o and do take the type of q; lse is float32")
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, o, lse, do, scale)
    _check_kernel_inputs(q, k, v, o, lse, do)
    dq, dkk, dvv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, lq), dtype=torch.float32, device=q.device)
    lib = _bwd_kernel_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.ieagan_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dkk.data_ptr(),
        dvv.data_ptr(), b, lq, lkv, dk, dv, float(scale), _DTYPE_CODES[q.dtype],
        q.device.index, stream)
    if err != 0:
        raise RuntimeError("attention backward kernel launch failed: "
                           + lib.ieagan_cuda_error_string(err).decode())
    attention_bwd.launches += 1
    return dq, dkk, dvv


attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable fused attention over 3-D q, k, v: B1 forward, B2
    backward (the twin of the JAX package's ``_flash_attention_3d`` custom
    VJP). Both run their kernels on CUDA tensors and their plain versions on
    CPU tensors. Once differentiable: a backward with ``create_graph=True``
    raises, since B2's output carries no gradient. Traced, the backward is
    the span ``<span_name>.bwd`` (``span_name``: the forward's span,
    ``ops/attention.py::attention_site``)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, span_name: str = "ieagan.attn"):
        o, lse = attention_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        ctx.span_name = span_name
        return o

    @staticmethod
    def backward(ctx, do):
        if torch.is_grad_enabled():
            raise RuntimeError("FlashAttention's backward (B2) is not differentiable: "
                               "create_graph=True cannot pass through fused attention; "
                               "use the plain attention for higher-order gradients")
        with span(ctx.span_name + ".bwd"):
            q, k, v, o, lse = ctx.saved_tensors
            dq, dk, dv = attention_bwd(q, k, v, o, lse, do.contiguous(), ctx.scale)
        return dq, dk, dv, None, None
