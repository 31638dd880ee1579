"""The mesh over ``torch.distributed`` (twin of ``ieagan_tpu/core/mesh.py``).

The JAX package lays a ``jax.sharding.Mesh`` with a ``"data"`` axis and a
``"model"`` axis over its devices (``devices.reshape(n_data, n_model)``) and
lets XLA insert the collectives. Here one process drives one GPU, and the
processes of the default group are laid out the same way: rank
``data_index * n_model + model_index``.

  * ``"data"``: the ranks of one ``model_index`` (``data_group``) hold the
    ``data_index``-th slice of every global batch's events, and the train
    step reduces over them where the JAX step's global view reduces over the
    batch (``parallel/collectives.py``, ``ops/norm.py``, ``train/step.py``);
  * ``"model"``: the ranks of one ``data_index`` (``model_group``) hold the
    same rows and each its shard of every leaf that the tensor-parallel rule
    splits (``parallel/sharding.py::param_split``); the split layers
    (``parallel/tensor.py``) gather, scatter and reduce over them.
"""

from __future__ import annotations

import dataclasses

import torch.distributed as dist

from ieagan_torch.parallel import distributed


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``n_data`` x ``n_model`` ranks of the default process group, this
    process's global ``rank``, and the process groups of its two axes
    (``None``: the default group, when an axis spans the world, or no group
    at all, when it is one rank wide)."""
    n_data: int
    rank: int
    n_model: int = 1
    data_group: object = dataclasses.field(default=None, compare=False, repr=False)
    model_group: object = dataclasses.field(default=None, compare=False, repr=False)

    def __deepcopy__(self, memo):
        return self  # immutable, and its process groups cannot be copied

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "model": self.n_model}

    def rows(self, n_local: int) -> slice:
        """This rank's rows of a global batch of ``n_data * n_local`` rows."""
        return slice(self.data_index * n_local, (self.data_index + 1) * n_local)


def make_mesh(n_data: int | None = None, n_model: int = 1) -> Mesh:
    """The ``n_data`` x ``n_model`` mesh over every process of the default
    group (the world); ``n_data`` defaults to ``world // n_model`` and
    ``n_data * n_model`` must equal the world. Every rank must call it, in
    the same order: it makes the axes' process groups."""
    world = distributed.world_size()
    n_model = int(n_model)
    if n_model < 1 or world % n_model:
        raise ValueError(f"mesh model axis {n_model} must divide the world of {world} "
                         "processes")
    n_data = world // n_model if n_data is None else int(n_data)
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} must span the world of {world} processes "
                         "(one process per GPU: torchrun --nproc-per-node N ... --mesh "
                         "<data>x<model>)")
    data_group = model_group = None
    if 1 < n_model < world:
        # every rank makes every group, in the same order (dist.new_group's contract)
        for d in range(n_data):
            group = dist.new_group([d * n_model + m for m in range(n_model)])
            if d == distributed.rank() // n_model:
                model_group = group
        for m in range(n_model):
            group = dist.new_group([d * n_model + m for d in range(n_data)])
            if m == distributed.rank() % n_model:
                data_group = group
    return Mesh(n_data=n_data, rank=distributed.rank(), n_model=n_model,
                data_group=data_group, model_group=model_group)


def parse_mesh_spec(spec) -> tuple[int, int]:
    """Parse the ``mesh`` config key -> (n_data, n_model).

    Accepts a dict ({"data": N[, "model": M]}, the documented JSON form), a
    string ("NxM", "N", or "data:N,model:M"), or an int (pure data
    parallel). The CLI flag arrives as a string.
    """
    if isinstance(spec, dict):
        return int(spec.get("data", 1)), int(spec.get("model", 1))
    if isinstance(spec, int):
        return spec, 1
    s = str(spec).strip().lower()
    if ":" in s:  # "data:4,model:2"
        parts = dict(kv.split(":") for kv in s.split(","))
        return int(parts.get("data", 1)), int(parts.get("model", 1))
    if "x" in s:  # "4x2"
        a, b = s.split("x")
        return int(a), int(b)
    return int(s), 1
