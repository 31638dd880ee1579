"""The data-parallel mesh over ``torch.distributed`` (twin of
``ieagan_tpu/core/mesh.py``).

The JAX package lays a ``jax.sharding.Mesh`` with a ``"data"`` axis (and an
optional ``"model"`` axis) over its devices and lets XLA insert the
collectives. Here one process drives one GPU, and the data axis is the
processes of the default process group: rank ``r`` of ``N`` holds the
``r``-th slice of every global batch's events, and the train step reduces
over the group where the JAX step's global view reduces over the batch
(``parallel/collectives.py``, ``ops/norm.py``, ``train/step.py``).

The ``"model"`` axis (tensor parallelism, ``ieagan_tpu/parallel/sharding.py:
46-83``) is not ported: ``make_mesh`` refuses ``n_model > 1``.
"""

from __future__ import annotations

import dataclasses

from ieagan_torch.parallel import distributed


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data axis: ``n_data`` ranks of the default process group and
    this process's ``rank``."""
    n_data: int
    rank: int

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "model": 1}

    def rows(self, n_local: int) -> slice:
        """This rank's rows of a global batch of ``n_data * n_local`` rows."""
        return slice(self.rank * n_local, (self.rank + 1) * n_local)


def make_mesh(n_data: int | None = None, n_model: int = 1) -> Mesh:
    """The data axis over every process of the default group (the world).
    ``n_data`` defaults to the world size and must equal it."""
    if n_model > 1:
        raise NotImplementedError(
            f"mesh model axis {n_model}: not ported (tensor parallelism, ROADMAP §A)")
    world = distributed.world_size()
    n_data = world if n_data is None else int(n_data)
    if n_data != world:
        raise ValueError(f"mesh data axis {n_data} must span the world of {world} processes "
                         "(one process per GPU: torchrun --nproc-per-node N ... --mesh N)")
    return Mesh(n_data=n_data, rank=distributed.rank())


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
