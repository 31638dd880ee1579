"""Checkpoints in the JAX package's file-per-component layout (twin of
``ieagan_tpu/utils/checkpoint.py``; reference: utils/__init__.py:592-726).

A run's weights dir holds, per tag (``copy<N>``, ``best<N>``), one
flax-msgpack file per component (``G_<tag>``, ``D_<tag>``, ``G_optim_<tag>``,
``D_optim_<tag>``, ``G_ema_<tag>``) and ``state_dict_<tag>.json`` with the
run's bookkeeping and ``itr``. Both packages read and write the same files:
the port converts its modules and optimizers with ``models/convert.py`` and
writes with its own msgpack writer, each file atomically (temporary file,
then rename). Under data parallelism every rank holds the same state: the
driver calls ``save_checkpoint`` on rank 0 alone (``ieagan_tpu/utils/
checkpoint.py:144``); every rank may read. Under tensor parallelism each
rank holds shards: every rank gathers them whole first
(``parallel/sharding.py::full_state``), so rank 0 writes the files one
process writes, and ``load_checkpoint`` with the mesh reads the whole leaves
and keeps each rank's shards; a checkpoint so moves between a 1x1, a 1x2 and
a 2x2 mesh. The JAX package's device-to-host packing (``_to_host``,
``utils/transfer.py``) exists for a network-attached TPU and has no twin.
"""

from __future__ import annotations

import json
import os
import pathlib

import torch

from ieagan_torch.models.convert import (discriminator_state_from_flax,
                                         discriminator_state_to_flax,
                                         generator_state_from_flax,
                                         generator_state_to_flax,
                                         optimizer_state_from_flax,
                                         optimizer_state_to_flax)
from ieagan_torch.parallel.tensor import split_layers
from ieagan_torch.utils.flax_msgpack import (latest_checkpoint, msgpack_serialize,
                                             read_checkpoint)

__all__ = ["latest_checkpoint", "load_checkpoint", "save_checkpoint"]


def _join(name_suffix: str | None, base: str) -> str:
    return f"{base}_{name_suffix}" if name_suffix else base


def _atomic_write(path: pathlib.Path, data: bytes):
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as fp:
        fp.write(data)
    os.replace(tmp, path)


def _refuse_shards(state):
    if any(split_layers(net) for net in (state.G, state.D, state.G_ema)):
        raise ValueError("the state holds tensor-parallel shards: gather it whole first "
                         "(parallel/sharding.py::full_state), or pass the mesh to load")


def save_checkpoint(weights_dir, state, state_dict: dict, name_suffix: str | None = None):
    """Save every component of the ``TrainState`` ``state`` and
    ``state_dict`` (with ``itr`` set to the state's) under ``weights_dir``.
    A state holding shards is refused."""
    _refuse_shards(state)
    weights_dir = pathlib.Path(weights_dir)
    components = {
        "G": generator_state_to_flax(state.G),
        "D": discriminator_state_to_flax(state.D),
        "G_optim": optimizer_state_to_flax(state.opt_G, state.G),
        "D_optim": optimizer_state_to_flax(state.opt_D, state.D),
        "G_ema": generator_state_to_flax(state.G_ema),
    }
    weights_dir.mkdir(parents=True, exist_ok=True)
    for base, tree in components.items():
        _atomic_write(weights_dir / f"{_join(name_suffix, base)}.msgpack",
                      msgpack_serialize(tree))
    sd = dict(state_dict)
    sd["itr"] = int(state.itr)
    _atomic_write(weights_dir / f"{_join(name_suffix, 'state_dict')}.json",
                  json.dumps(sd).encode())


def _graft(template, src):
    """Every leaf of ``src`` that the template has, the template's elsewhere
    (``ieagan_tpu/utils/checkpoint.py:293-298``)."""
    if isinstance(template, dict):
        return {k: (_graft(v, src.get(k)) if isinstance(src, dict) else v)
                for k, v in template.items()}
    return template if src is None else src


def _load_module(module, tree, convert):
    state = convert(tree, module.state_dict())
    module.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)


def _load_optimizer(path: pathlib.Path, opt, model, itr: int):
    tree = read_checkpoint(path)
    try:
        optimizer_state_from_flax(opt, model, tree)
    except KeyError:
        # Optimizer files saved before round 5 of the JAX package serialize
        # the constant-lr chain (an empty state where the schedule's count
        # now is). Take every leaf the file has, keep the optimizer's own for
        # the rest, and seed the schedule's count with the resumed itr (the
        # reference scheduler's position, train.py:244-247).
        print(f"checkpoint '{path.name}': legacy optimizer structure; "
              "grafting into the scheduled-optimizer tree")
        optimizer_state_from_flax(opt, model, _graft(optimizer_state_to_flax(opt, model), tree))
        opt.sched_count = itr


def load_checkpoint(weights_dir, state, name_suffix: str | None = None,
                    load_optim: bool = True, mesh=None):
    """Restore the ``TrainState`` ``state`` in place from checkpoint
    ``name_suffix`` under ``weights_dir``: G, D and G_ema, with
    ``load_optim`` the Adam moments and counts, and ``itr``. Returns
    ``(state, state_dict)``. A state holding tensor-parallel shards needs
    its ``mesh``, and every rank of it calls this: each reads the whole
    leaves and keeps its shards."""
    if mesh is not None and mesh.n_model > 1:
        from ieagan_torch.parallel.sharding import full_state
        with full_state(state, mesh):
            return _load(weights_dir, state, name_suffix, load_optim)
    _refuse_shards(state)
    return _load(weights_dir, state, name_suffix, load_optim)


def _load(weights_dir, state, name_suffix, load_optim):
    weights_dir = pathlib.Path(weights_dir)
    with open(weights_dir / f"{_join(name_suffix, 'state_dict')}.json") as fp:
        sd = json.load(fp)
    path = lambda base: weights_dir / f"{_join(name_suffix, base)}.msgpack"
    _load_module(state.G, read_checkpoint(path("G")), generator_state_from_flax)
    _load_module(state.D, read_checkpoint(path("D")), discriminator_state_from_flax)
    _load_module(state.G_ema, read_checkpoint(path("G_ema")), generator_state_from_flax)
    itr = int(sd.get("itr", 0))
    if load_optim:
        _load_optimizer(path("G_optim"), state.opt_G, state.G, itr)
        _load_optimizer(path("D_optim"), state.opt_D, state.D, itr)
    state.itr = itr
    return state, sd
