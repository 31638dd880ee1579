"""Carry-over of the JAX package's generator and discriminator variables into
the port.

The JAX package stores a model as ``{"params": ..., "state": {"spectral":
..., "batch_stats": ...}}`` (``ieagan_tpu/utils/checkpoint.py``; D has no
batch stats). The port's ``Generator`` and ``Discriminator`` name their
submodules after that tree, so a leaf's path carries over unchanged and only
the leaf names and layouts map, after the conventions of
``ieagan_tpu/models/convert.py``:

  params     .../kernel (kh, kw, I, O)  -> .../weight (O, I, kh, kw)
             .../kernel (in, out)       -> .../weight (out, in)
             .../embedding (n, d)       -> .../weight (n, d)   (SN or not)
             .../scale (LayerNorm)      -> .../weight
             .../bias, .../gain, .../gamma -> the same names
  spectral   .../u (num_svs, out), .../sv (num_svs,)   -> .../u, .../sv
  batch_stats .../mean, .../var, .../accumulation_counter -> the same names
"""

from __future__ import annotations

from typing import Mapping

import numpy as np


def _flatten(tree: Mapping, prefix: tuple = ()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, np.asarray(value)


def _param_leaf(path: tuple, value: np.ndarray):
    *module, leaf = path
    if leaf == "kernel":
        if value.ndim == 4:
            return module + ["weight"], value.transpose(3, 2, 0, 1)
        if value.ndim == 2:
            return module + ["weight"], value.T
    elif leaf in ("embedding", "scale"):
        return module + ["weight"], value
    elif leaf in ("bias", "gain", "gamma"):
        return module + [leaf], value
    raise KeyError(f"params leaf {'/'.join(path)} with shape {value.shape} "
                   "has no counterpart in the port")


def generator_state_from_flax(variables: Mapping, template: Mapping | None = None) -> dict:
    """A state dict (numpy arrays, PyTorch layout) for the port's Generator
    from the JAX package's ``{"params", "state"}`` variables.

    Raises ``KeyError`` on a leaf it cannot map. With ``template`` (the
    port's ``state_dict()``), it also raises when a key of the template is
    missing, when a converted key is left unused by the template, or when a
    shape differs."""
    return _state_from_flax(variables, template, "Generator")


def discriminator_state_from_flax(variables: Mapping, template: Mapping | None = None) -> dict:
    """A state dict (numpy arrays, PyTorch layout) for the port's
    Discriminator from the JAX package's ``{"params", "state"}`` variables,
    with the checks of ``generator_state_from_flax``."""
    return _state_from_flax(variables, template, "Discriminator")


def _state_from_flax(variables: Mapping, template: Mapping | None, what: str) -> dict:
    extra = set(variables) - {"params", "state"}
    if extra:
        raise KeyError(f"unexpected top-level keys {sorted(extra)}")
    out: dict[str, np.ndarray] = {}
    for path, value in _flatten(variables["params"]):
        name, arr = _param_leaf(path, value)
        out[".".join(name)] = arr
    for collection, tree in variables.get("state", {}).items():
        allowed = {"spectral": ("u", "sv"),
                   "batch_stats": ("mean", "var", "accumulation_counter")}.get(collection)
        if allowed is None:
            raise KeyError(f"state collection {collection!r} has no counterpart in the port")
        for path, value in _flatten(tree):
            if path[-1] not in allowed:
                raise KeyError(f"{collection} leaf {'/'.join(path)} has no "
                               "counterpart in the port")
            out[".".join(path)] = value
    out = {k: np.array(v, dtype=np.float32, order="C") for k, v in out.items()}
    if template is not None:
        missing = sorted(set(template) - set(out))
        unused = sorted(set(out) - set(template))
        if missing or unused:
            raise KeyError(f"checkpoint does not fit the port's {what}: "
                           f"missing {missing[:8]} ({len(missing)}), "
                           f"unused {unused[:8]} ({len(unused)})")
        bad = [k for k in out if tuple(out[k].shape) != tuple(template[k].shape)]
        if bad:
            raise ValueError("shape mismatch: " + ", ".join(
                f"{k} {out[k].shape} vs {tuple(template[k].shape)}" for k in bad[:8]))
    return out
