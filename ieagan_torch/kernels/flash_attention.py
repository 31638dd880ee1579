"""Fused attention forward (B1): the CUDA kernel's wrapper and its plain version.

``attention_fwd(q, k, v, scale)`` returns ``o = softmax(scale * q kᵀ) v`` and
the f32 row statistic ``lse = m + log(sum exp(s - m))`` over 3-D tensors
``q (B, Lq, dk)``, ``k (B, Lkv, dk)``, ``v (B, Lkv, dv)``. It is the twin of
``ieagan_tpu/ops/pallas/flash_attention.py::_fwd``: softmax statistics and
accumulation are f32, ``o`` takes the input type.

For CUDA tensors it launches ``csrc/attention_fwd.cu`` (built by
``kernels/build.py`` at first use) on the current stream, or raises. For CPU
tensors it computes ``attention_fwd_plain``, the same function in plain
PyTorch. Nothing falls back from the one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from ieagan_torch.kernels import build

MAX_HEAD_DIM = 128  # the kernel's register tile holds dk, dv <= 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LIB_NAME = "attention_fwd"
_LIB: ctypes.CDLL | None = None


def attention_fwd_plain(q, k, v, scale: float):
    """Plain PyTorch B1: f32 scores, f32 softmax, f32 product, ``o`` cast to
    the type of ``q``. Used for CPU tensors and as the kernel's reference."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.matmul(p, v.float())
    return o.to(q.dtype), lse


def _kernel_library() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signatures set."""
    global _LIB
    if _LIB is None:
        lib = build.load(_LIB_NAME)
        lib.ieagan_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        lib.ieagan_attention_fwd.restype = ctypes.c_int
        lib.ieagan_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ieagan_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


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


def attention_fwd(q, k, v, scale: float):
    """B1 forward: ``(o (B, Lq, dv) in q's type, lse (B, Lq) f32)``.

    CUDA tensors go to the kernel, which takes f32 or bf16, ``dk, dv <= 128``
    and contiguous tensors, and raises on anything else. CPU tensors go to
    ``attention_fwd_plain``. ``attention_fwd.launches`` counts kernel
    launches."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_fwd_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"attention_fwd runs on CUDA or CPU, not {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the attention kernel takes float32 or bfloat16, not {q.dtype}")
    b, lq, dk = q.shape
    lkv, dv = v.shape[1], v.shape[2]
    if dk > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise ValueError(f"the attention kernel takes dk, dv <= {MAX_HEAD_DIM}; "
                         f"got dk={dk}, dv={dv}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the attention kernel takes contiguous q, k, v")
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
