"""Collectives over the mesh's data axis, with autograd.

The JAX package has no twin of this module: under ``jax.jit`` with the event
axis sharded, XLA inserts the all-reduces that batch-wide reductions need.
Here the train step calls them where the JAX step's global view reduces over
the batch: batch-norm moments (``ops/norm.py``), D's full-batch RRM sequence
(``models/discriminator.py``), the prior embedding's norm (``ops/prior.py``),
the losses that pair every image with every other (``train/step.py``), the
gradients and the metrics. The models' three take their mesh from
``global_batch``, a context the step enters.

Each function takes a ``core/mesh.py::Mesh`` (or ``None``) and is the
identity with one process. The backward of each is its adjoint, so a rank's
``backward()`` yields its share of the gradient of the mean of the ranks'
losses once ``all_reduce_grads`` has averaged it:

  * ``all_reduce_sum``: forward and backward both sum over the ranks;
  * ``all_gather_rows``: forward concatenates every rank's rows in rank
    order; backward sums the gathered gradient over the ranks and keeps this
    rank's rows (a reduce-scatter, written as an all-reduce and a slice
    because gloo has no reduce-scatter).
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.distributed as dist

# The mesh whose global batch the models' batch-wide operations span, set by
# the train step for its own forwards only: rank 0's sampling and FID
# generation outside the step take their own batch and run no collective.
_BATCH_MESH = contextvars.ContextVar("batch_mesh", default=None)


def _single(mesh) -> bool:
    return mesh is None or mesh.n_data == 1


@contextlib.contextmanager
def global_batch(mesh):
    """Inside the block, train-mode batch norm takes its moments over the
    global batch of ``mesh`` (``ops/norm.py``), D's full-batch RRM sequence
    is the global batch (``models/discriminator.py``) and the prior
    embedding's norm spans it (``ops/prior.py``). With ``None`` or one rank,
    the local batch."""
    token = _BATCH_MESH.set(None if _single(mesh) else mesh)
    try:
        yield
    finally:
        _BATCH_MESH.reset(token)


def batch_mesh():
    """The mesh of the enclosing ``global_batch``, or None (the local batch)."""
    return _BATCH_MESH.get()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = x.contiguous().clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.n_local = mesh, x.shape[0]
        return _gather(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad[ctx.mesh.rows(ctx.n_local)], None


def _gather(x, mesh):
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.n_data)]
    dist.all_gather(parts, x)
    return torch.cat(parts)


def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over the ranks (every rank's ``x`` of one shape)."""
    if _single(mesh):
        return x
    return _AllReduceSum.apply(x)


def all_gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``x`` (one shape on all) concatenated along dim 0 in rank
    order: the global batch's rows. Integer tensors are gathered without
    autograd."""
    if _single(mesh):
        return x
    if not x.requires_grad:
        return _gather(x, mesh)
    return _AllGatherRows.apply(x, mesh)


def _in_one_bucket(tensors: list, op) -> None:
    """``op`` on one flat copy of ``tensors`` (one dtype), copied back."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    op(flat)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


@torch.no_grad()
def all_reduce_grads(module: torch.nn.Module, mesh) -> None:
    """Average every parameter's ``.grad`` over the ranks, through one flat
    bucket; every parameter must have a gradient (the step zero-fills)."""
    if _single(mesh):
        return

    def average(flat):
        dist.all_reduce(flat)
        flat.div_(mesh.n_data)

    _in_one_bucket([p.grad for p in module.parameters()], average)


@torch.no_grad()
def broadcast_tensors(tensors: list, mesh, src: int = 0) -> None:
    """Overwrite ``tensors`` in place with rank ``src``'s values, one flat
    bucket per dtype."""
    if _single(mesh):
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        _in_one_bucket(same, lambda flat: dist.broadcast(flat, src=src))
