"""Process bootstrap for data-parallel training (twin of
``ieagan_tpu/parallel/distributed.py``).

One process per GPU, launched by ``torchrun`` (or anything that sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``). Every process calls :func:`initialize` first; without
``WORLD_SIZE`` or ``MASTER_ADDR`` in the environment it is a no-op and the
run is single-process, as the JAX package's is without a coordinator.

The backend is NCCL on CUDA and gloo on the CPU unless asked for another.
Nothing here falls back: a failing NCCL or CUDA set-up raises.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist


def local_device(device_type: str = "cuda") -> torch.device:
    """This process's device: ``cuda:LOCAL_RANK`` (0 without a launcher) or
    the CPU."""
    if torch.device(device_type).type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def initialize(backend: str | None = None, device_type: str = "cuda",
               timeout_s: float | None = None) -> None:
    """Join the default process group from the launcher's environment, once;
    binds ``cuda:LOCAL_RANK`` on CUDA. ``backend`` defaults to ``nccl`` for
    CUDA and ``gloo`` for the CPU; ``timeout_s`` bounds every collective
    (ranks wait in a collective while rank 0 runs the FID test)."""
    if dist.is_initialized():
        return
    if "WORLD_SIZE" not in os.environ or "MASTER_ADDR" not in os.environ:
        return  # nothing to coordinate with: a single-process run
    device = local_device(device_type)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=float(timeout_s))
    if device.type == "cuda":
        torch.cuda.set_device(device)
        if backend == "nccl":
            kwargs["device_id"] = device
    dist.init_process_group(backend, init_method="env://",
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]), **kwargs)


def shutdown() -> None:
    """Leave the process group (no-op when none was joined)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def backend() -> str | None:
    """The default group's backend (``nccl``, ``gloo``), None without one."""
    return dist.get_backend() if dist.is_initialized() else None


def is_multiprocess() -> bool:
    return world_size() > 1


def broadcast_object(obj, src: int = 0):
    """``obj`` as rank ``src`` holds it, on every rank (picklable objects;
    the object itself with one process)."""
    if not is_multiprocess():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]
