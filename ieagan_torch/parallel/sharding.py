"""State placement over the mesh and the sharded train step (twin of
``ieagan_tpu/parallel/sharding.py``).

The JAX package places the state on its mesh (replicated, or split over the
``"model"`` axis for tensor parallelism) and jits one step over event-sharded
inputs. Here ``place_state`` makes the state rank 0's on every rank, then,
with a model axis, keeps on each rank its shard of every leaf that the JAX
rule splits (``param_split``) in G, D, G_ema and both Adam moments, the
layers that hold them becoming split layers (``parallel/tensor.py``). SN
``u``/``sv``, the BN stats and ``itr`` stay whole and replicated, as the
JAX ``place_state`` keeps ``state_*`` replicated.
``make_sharded_train_step`` is the port's step with the mesh, which reduces
over the data axis where the JAX step's global view reduces over the batch
(``train/step.py``). Each rank takes its data index's rows of every global
batch (``host_local_batch``; the driver's loader and debug batches load only
those rows).

``gather_state`` makes every split leaf whole again on every rank of the
model axis and the layers plain (a checkpoint's save and rank 0's sampling
read that state), ``split_state`` keeps each rank's shard of it again, and
``full_state`` is the pair as a context: a checkpoint moves between a 1x1,
a 1x2 and a 2x2 mesh as the same flax-msgpack files.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ieagan_torch.models.convert import _flax_param_layout
from ieagan_torch.ops.image_norm import device_event_transform
from ieagan_torch.parallel import tensor
from ieagan_torch.parallel.collectives import (broadcast_tensors, model_gather,
                                               model_parallel)
from ieagan_torch.parallel.distributed import broadcast_object
from ieagan_torch.train.step import make_train_step

# Second members of the known back-to-back pairs (the RRM's MLP
# linear1 -> linear2, its attention qkv_proj -> o_proj, SA-GAN's g -> o):
# their input (contracting) axis is split, a Megatron row split
# (ieagan_tpu/parallel/sharding.py:40-46).
ROW_SHARD_NAMES = frozenset({"linear2", "o_proj", "o"})


def param_split(path: tuple, shape: tuple, n_model: int, min_shard_dim: int = 64):
    """The JAX rule (``ieagan_tpu/parallel/sharding.py::param_shardings``
    with ``tensor_parallel``) for one flax params leaf: ``("row", -2)`` for
    the kernel of a pair's second layer whose input axis is wide and
    divides, ``("column", -1)`` for any leaf of two or more dimensions whose
    last (output) axis is wide and divides, else ``None`` (replicated).
    ``path`` and ``shape`` are the flax leaf's."""
    if n_model <= 1 or len(shape) < 2:
        return None
    if (len(path) >= 2 and path[-1] == "kernel" and path[-2] in ROW_SHARD_NAMES
            and shape[-2] % n_model == 0 and shape[-2] >= min_shard_dim):
        return "row", -2
    if shape[-1] % n_model == 0 and shape[-1] >= min_shard_dim:
        return "column", -1
    return None


def split_rule(model: torch.nn.Module, n_model: int, min_shard_dim: int = 64) -> dict:
    """``{parameter name: (style, torch dim)}`` of ``model``'s leaves that
    ``param_split`` splits over ``n_model`` ranks: each parameter is read as
    its flax leaf (path and shape) through ``models/convert.py``'s layout
    map, and the flax axis is mapped back to the torch dim through it."""
    out = {}
    for name, (path, to_flax) in _flax_param_layout(model).items():
        shape = tuple(model.get_parameter(name).shape)
        flax_shape = to_flax(np.broadcast_to(np.float32(0), shape)).shape
        split = param_split(path, flax_shape, n_model, min_shard_dim)
        if split is None:
            continue
        style, axis = split
        # a probe of distinct sizes tells which torch dim becomes the flax axis
        probe = (2, 3, 5, 7)[:len(shape)]
        out[name] = (style, probe.index(to_flax(np.broadcast_to(np.float32(0), probe))
                                        .shape[axis]))
    return out


def _nets(state):
    return ((state.G, state.opt_G), (state.D, state.opt_D), (state.G_ema, None))


def _moments(opt, p) -> list:
    return [] if opt is None else [opt.state[p][m] for m in opt.moment_names]


@torch.no_grad()
def split_state(state, mesh):
    """Keep on this rank its shard of every leaf of ``state`` that the rule
    splits over ``mesh``'s model axis (G, D, G_ema and both Adam moments),
    in place: the first call reads the rule off the whole modules, a later
    one (after ``gather_state``) the split each layer kept. Returns
    ``state``."""
    if not model_parallel(mesh):
        return state
    for net, opt in _nets(state):
        if tensor.split_layers(net):
            raise ValueError("the state already holds shards")
        splits = getattr(net, "_tp_splits", None)
        if splits is None:
            splits = tensor.layer_splits(net, split_rule(net, mesh.n_model), mesh)
            net._tp_splits = splits
        modules = dict(net.named_modules())
        for name, split in splits.items():
            module = modules[name]
            for i, m in enumerate(_moments(opt, module.weight)):
                opt.state[module.weight][opt.moment_names[i]] = tensor.shard(
                    m, split.dim, mesh)
            tensor.split_layer(module, split)
        tensor.pair_attention(net)
    return state


@torch.no_grad()
def gather_state(state, mesh):
    """Make every split leaf of ``state`` whole on every rank of ``mesh``'s
    model axis (a collective: every rank calls it) and its layer plain, in
    place. Returns ``state``."""
    if not model_parallel(mesh):
        return state
    for net, opt in _nets(state):
        for _, module in tensor.split_layers(net):
            p, dim = module.weight, module.tp.dim
            moments = [model_gather(m, dim, mesh) for m in _moments(opt, p)]
            for i, m in enumerate(moments):
                opt.state[p][opt.moment_names[i]] = m
            tensor.unsplit_layer(module, model_gather(p.data, dim, mesh))
        tensor.pair_attention(net)
    return state


@contextlib.contextmanager
def full_state(state, mesh):
    """Inside the block every leaf of ``state`` is whole on every rank and
    its layers plain (``gather_state``); on leaving, each rank keeps its
    shard of what the leaves then hold (``split_state``), loaded weights
    included. Every rank of the model axis enters it."""
    if not model_parallel(mesh):
        yield state
        return
    gather_state(state, mesh)
    try:
        yield state
    finally:
        split_state(state, mesh)


@torch.no_grad()
def full_tensors(module: torch.nn.Module, tensors: dict, mesh) -> dict:
    """``{parameter name: tensor}`` of ``module`` (its shards' gradients,
    say) with every split parameter's tensor gathered whole over the model
    axis (a collective)."""
    if not model_parallel(mesh):
        return dict(tensors)
    dims = {f"{n}.weight": m.tp.dim for n, m in tensor.split_layers(module)}
    return {k: model_gather(v, dims[k], mesh) if k in dims else v for k, v in tensors.items()}


def place_state(state, mesh):
    """Make ``state`` (a ``train/step.py::TrainState``) rank 0's on every
    rank, in place: every parameter and buffer of G, D and G_ema (SN ``u``
    and ``sv``, BN stats, the standing counter), both optimizers' moments and
    counts, and ``itr``; then, with a model axis, each rank keeps its shards
    (``split_state``). Returns ``state``."""
    if mesh is None or mesh.n_data * mesh.n_model == 1:
        return state
    tensors = [t for m in (state.G, state.D, state.G_ema) for t in m.state_dict().values()]
    for opt in (state.opt_G, state.opt_D):
        tensors += [opt.state[p][name] for p in opt.params for name in opt.moment_names]
    broadcast_tensors(tensors, mesh)
    counts = broadcast_object((state.itr, state.opt_G.count, state.opt_G.sched_count,
                               state.opt_D.count, state.opt_D.sched_count))
    (state.itr, state.opt_G.count, state.opt_G.sched_count, state.opt_D.count,
     state.opt_D.sched_count) = counts
    return split_state(state, mesh)


def host_local_batch(mesh, *arrays):
    """This rank's rows of global host batches (arrays or tensors with a
    leading batch axis divisible by the data axis): its data index's; the
    arrays themselves with one data rank."""
    if mesh is not None and mesh.n_data > 1:
        arrays = tuple(a[mesh.rows(a.shape[0] // mesh.n_data)] for a in arrays)
    return arrays[0] if len(arrays) == 1 else arrays


def make_sharded_train_step(G, D, config, mesh, steps_per_epoch: int = 0,
                            device_transform: bool = False, **step_kwargs):
    """The train step of ``train/step.py`` over ``mesh``:
    ``step(state, x, y, generator)`` with x, y this rank's rows. With
    ``device_transform`` x is raw uint8 events and the pad/lognorm/noise
    chain runs first on the device, its noise drawn for the global batch
    and cut to this rank's rows (``ops/image_norm.py``). ``step_kwargs``
    go to ``make_train_step`` (``draw_schedule``, ``capture_grads``)."""
    step = make_train_step(G, D, config, steps_per_epoch, mesh=mesh, **step_kwargs)
    if not device_transform:
        return step
    n, index = (1, 0) if mesh is None else (mesh.n_data, mesh.data_index)

    def step_with_transform(state, raw, y, generator=None):
        b = raw.shape[0]
        x = device_event_transform(raw, generator, rows=(index * b, n * b))
        return step(state, x, y, generator)

    return step_with_transform
