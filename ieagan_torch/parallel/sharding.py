"""Data-parallel state placement and the sharded train step (twin of
``ieagan_tpu/parallel/sharding.py``).

The JAX package places the state on its mesh (replicated, or split over the
``"model"`` axis for tensor parallelism) and jits one step over event-sharded
inputs. Here every rank holds the whole state on its own GPU: ``place_state``
makes it rank 0's everywhere, and ``make_sharded_train_step`` is the port's
step with the mesh, which reduces over the ranks where the JAX step's global
view reduces over the batch (``train/step.py``). Each rank takes its own
rows of every global batch (``host_local_batch``; the driver's loader and
debug batches load only those rows).

Tensor parallelism (the JAX package's ``param_shardings`` column/row rule)
is not ported: ``core/mesh.py::make_mesh`` refuses a model axis.
"""

from __future__ import annotations

from ieagan_torch.ops.image_norm import device_event_transform
from ieagan_torch.parallel.collectives import broadcast_tensors
from ieagan_torch.parallel.distributed import broadcast_object
from ieagan_torch.train.step import make_train_step


def place_state(state, mesh):
    """Make ``state`` (a ``train/step.py::TrainState``) rank 0's on every
    rank, in place: every parameter and buffer of G, D and G_ema (SN ``u``
    and ``sv``, BN stats, the standing counter), both optimizers' moments and
    counts, and ``itr``. Returns ``state``."""
    if mesh is None or mesh.n_data == 1:
        return state
    tensors = [t for m in (state.G, state.D, state.G_ema) for t in m.state_dict().values()]
    for opt in (state.opt_G, state.opt_D):
        tensors += [opt.state[p][name] for p in opt.params for name in opt.moment_names]
    broadcast_tensors(tensors, mesh)
    counts = broadcast_object((state.itr, state.opt_G.count, state.opt_G.sched_count,
                               state.opt_D.count, state.opt_D.sched_count))
    (state.itr, state.opt_G.count, state.opt_G.sched_count, state.opt_D.count,
     state.opt_D.sched_count) = counts
    return state


def host_local_batch(mesh, *arrays):
    """This rank's rows of global host batches (arrays or tensors with a
    leading batch axis divisible by the data axis); the arrays themselves
    with one rank."""
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
    n, rank = (1, 0) if mesh is None else (mesh.n_data, mesh.rank)

    def step_with_transform(state, raw, y, generator=None):
        b = raw.shape[0]
        x = device_event_transform(raw, generator, rows=(rank * b, n * b))
        return step(state, x, y, generator)

    return step_with_transform
