"""Activation recompute: the port's twin of flax ``nn.remat`` as the JAX
models use it (``ieagan_tpu/models/generator.py:214-287``,
``ieagan_tpu/models/discriminator.py:148-184``).

A segment keeps its inputs for the backward, not its activations, and runs
again inside the backward (``torch.utils.checkpoint``, non-reentrant). flax's
recompute sees the variables the forward saw and drops its own writes. The
port keeps that state in its modules and writes it in place, so a segment:

  * snapshots the spectral-norm vectors ``u`` of its modules at entry; the
    recompute's power iteration starts from the snapshot, not from the ``u``
    the forward already advanced, and so computes the forward's W/σ
    (``ops/spectral.py``);
  * writes no state while it recomputes: no ``u`` or ``sv``, no running or
    standing batch-norm statistics (``ops/norm.py``);
  * recomputes in the ``contextvars`` context the forward ran in (the mesh
    of ``parallel/collectives.py::global_batch`` among them), whichever
    thread runs the backward: CUDA's backward runs in a thread of its own,
    which sees no context of the caller.

Segments hold no random draws. A recompute reruns the fused attention's
forward (B1) when a segment holds attention.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
from torch.utils.checkpoint import checkpoint

# Inside a recompute: {module: its u at the segment's entry}; None otherwise.
_RECOMPUTE = contextvars.ContextVar("remat_recompute", default=None)


def remat_mode(config: dict, net: str):
    """``False``, ``True`` or ``"wide"`` for ``net`` ("G" or "D"):
    ``remat_<net>`` where it is set, else ``remat``, as the JAX models'
    ``from_config`` resolve it. A string other than ``"wide"`` (the CLI
    gives ``--remat_G`` as one) reads as the CLI's boolean flags do; the
    JAX models take any such string as ``True``, ``"false"`` too."""
    mode = config.get(f"remat_{net}")
    if mode is None:
        mode = config.get("remat", False)
    if not isinstance(mode, str):
        return bool(mode)
    word = mode.strip().lower()
    if word == "wide":
        return "wide"
    if word in ("1", "true", "yes", "y"):
        return True
    if word in ("0", "false", "no", "n", "none", ""):
        return False
    raise ValueError(f"remat_{net} {mode!r}: expected True, False or 'wide'")


def recompute_u(module):
    """The ``u`` that ``module`` had at the entry of the segment being
    recomputed, or None outside a recompute (the module then reads and
    writes its own)."""
    snapshot = _RECOMPUTE.get()
    return None if snapshot is None else snapshot[module]


def recomputing() -> bool:
    """True inside a segment's recompute, where no state is written."""
    return _RECOMPUTE.get() is not None


@contextlib.contextmanager
def _recompute(context: contextvars.Context, snapshot: dict):
    tokens = [(var, var.set(value)) for var, value in context.items()]
    tokens.append((_RECOMPUTE, _RECOMPUTE.set(snapshot)))
    try:
        yield
    finally:
        for var, token in reversed(tokens):
            var.reset(token)


def segment(fn, modules, *args):
    """``fn(*args)`` as one recompute segment over ``modules`` (those whose
    state ``fn`` reads and writes). Without grad mode, the plain call."""
    if not torch.is_grad_enabled():
        return fn(*args)
    snapshot = {m: m.u.detach().clone() for module in modules for m in module.modules()
                if isinstance(getattr(m, "u", None), torch.Tensor)}
    context = contextvars.copy_context()
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _recompute(context, snapshot)))
