"""Collectives over the mesh's two axes, with autograd.

The JAX package has no twin of this module: under ``jax.jit`` with the event
axis sharded, XLA inserts the all-reduces that batch-wide reductions need.
Here the train step calls them where the JAX step's global view reduces over
the batch: batch-norm moments (``ops/norm.py``), D's full-batch RRM sequence
(``models/discriminator.py``), the prior embedding's norm (``ops/prior.py``),
the losses that pair every image with every other (``train/step.py``), the
gradients and the metrics. The models' three take their mesh from
``global_batch``, a context the step enters.

Each function takes a ``core/mesh.py::Mesh`` (or ``None``) and is the
identity with one process. The data axis's run over ``mesh.data_group``
(the ranks of one model index, which hold different rows); the backward of
each is its adjoint, so a rank's ``backward()`` yields its share of the
gradient of the mean of the ranks' losses once ``all_reduce_grads`` has
averaged it:

  * ``all_reduce_sum``: forward and backward both sum over the ranks;
  * ``all_gather_rows``: forward concatenates every rank's rows in rank
    order; backward sums the gathered gradient over the ranks and keeps this
    rank's rows (a reduce-scatter, written as an all-reduce and a slice
    because gloo has no reduce-scatter).

The model axis's (Megatron's operators) run over ``mesh.model_group``,
whose ranks hold the same rows and compute the same loss, so the gradient
reaching an operator's output is the whole gradient on every rank:

  * ``model_gather``: forward all-gathers the ranks' slices along a dim,
    backward keeps this rank's slice;
  * ``model_scatter``: forward keeps this rank's slice, backward
    all-gathers;
  * ``model_reduce``: forward sums the ranks' partial results, backward is
    the identity;
  * ``model_copy``: forward is the identity, backward sums the ranks'
    partial gradients (of a replicated input feeding split weights).

``all_reduce_sum``'s backward would sum the ranks' whole gradients on the
model axis and make them M times too large; a sum of partials whose
gradients are partial too (a split layer's sigma, ``parallel/tensor.py``) is
``model_reduce(model_copy(x))``.
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


def model_parallel(mesh) -> bool:
    """True when ``mesh`` has a model axis of more than one rank."""
    return mesh is not None and mesh.n_model > 1


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


def _summed(x, group):
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def _cat(x, n, group, dim=0):
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def _slice(x, n, index, dim):
    size = x.shape[dim] // n
    return x.narrow(dim, index * size, size).contiguous()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.group), None


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.n_local = mesh, x.shape[0]
        return _gather(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        grad = _summed(grad, ctx.mesh.data_group)
        return grad[ctx.mesh.rows(ctx.n_local)], None


def _gather(x, mesh):
    return _cat(x, mesh.n_data, mesh.data_group)


def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over the data axis's ranks (every rank's ``x`` of
    one shape)."""
    if _single(mesh):
        return x
    return _AllReduceSum.apply(x, mesh.data_group)


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
def all_reduce_grads(module: torch.nn.Module, mesh, split: frozenset = frozenset()) -> None:
    """Average every parameter's ``.grad`` over the data axis's ranks,
    through one flat bucket; every parameter must have a gradient (the step
    zero-fills). The gradients of the replicated parameters (those not in
    ``split``, a set of ``id``s of this rank's shards) are then averaged
    over the model axis too: its ranks compute them from the same rows, and
    cuDNN's weight gradients need not agree bit for bit, so without it the
    replicas would drift apart."""
    params = list(module.parameters())
    if not _single(mesh):
        def average(flat):
            dist.all_reduce(flat, group=mesh.data_group)
            flat.div_(mesh.n_data)

        _in_one_bucket([p.grad for p in params], average)
    if model_parallel(mesh):
        def model_average(flat):
            dist.all_reduce(flat, group=mesh.model_group)
            flat.div_(mesh.n_model)

        _in_one_bucket([p.grad for p in params if id(p) not in split], model_average)


@torch.no_grad()
def broadcast_tensors(tensors: list, mesh, src: int = 0) -> None:
    """Overwrite ``tensors`` in place with rank ``src``'s values on every
    rank of the world, one flat bucket per dtype."""
    if mesh is None or mesh.n_data * mesh.n_model == 1:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        _in_one_bucket(same, lambda flat: dist.broadcast(flat, src=src))


class _ModelGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return _cat(x, mesh.n_model, mesh.model_group, dim)

    @staticmethod
    def backward(ctx, grad):
        return _slice(grad, ctx.mesh.n_model, ctx.mesh.model_index, ctx.dim), None, None


class _ModelScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return _slice(x, mesh.n_model, mesh.model_index, dim)

    @staticmethod
    def backward(ctx, grad):
        return _cat(grad, ctx.mesh.n_model, ctx.mesh.model_group, ctx.dim), None, None


class _ModelReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _summed(x, mesh.model_group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ModelCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.mesh.model_group), None


def model_gather(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """The model axis's slices of ``x`` concatenated along ``dim`` in rank
    order; the backward keeps this rank's slice."""
    return _ModelGather.apply(x, dim, mesh) if model_parallel(mesh) else x


def model_scatter(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """This model rank's slice of ``x`` along ``dim``; the backward
    all-gathers the slices' gradients."""
    return _ModelScatter.apply(x, dim, mesh) if model_parallel(mesh) else x


def model_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of the model axis's partial ``x``; the backward passes the
    gradient through."""
    return _ModelReduce.apply(x, mesh) if model_parallel(mesh) else x


def model_copy(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` itself; the backward sums the model axis's partial gradients."""
    return _ModelCopy.apply(x, mesh) if model_parallel(mesh) else x
