"""Carry-over of the JAX package's generator, discriminator and optimizer
state into the port, and back.

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

``generator_state_to_flax`` and ``discriminator_state_to_flax`` go the other
way; they read each weight's flax name off the module that owns it (an
embedding's and a LayerNorm's weights keep their layout under ``embedding``
and ``scale``). ``optimizer_state_to_flax`` and ``optimizer_state_from_flax``
map ``train/optim.py::OptaxAdam`` onto the optax state tree the JAX package
saves (``ieagan_tpu/train/optim.py::make_optimizer``, read from
``artifacts/flagship_r4b/D_optim_copy16000.msgpack``)::

  adam, adabelief  {"0": {"count", "mu", "nu"}, "1": {"count"}}
  amsgrad          {"0": {"count", "mu", "nu", "nu_max"}, "1": {"count"}}
  with clip_norm   {"0": {}, "1": <one of the above>}

``"0"`` is the moments' state (``ScaleByAdamState`` and its twins) with
parameter trees in the flax layout, ``"1"`` the schedule wrapper's
``ScaleByScheduleState``, ``{}`` the clip's empty state. Counts are int32.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ieagan_torch.ops.norm import LayerNorm
from ieagan_torch.ops.spectral import Embedding, SNEmbedding


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


def _flax_param_layout(model: torch.nn.Module) -> dict:
    """Parameter name of the port -> (flax params path, port-to-flax layout)."""
    layout = {}
    for mod_name, module in model.named_modules():
        for leaf, p in module.named_parameters(recurse=False):
            path = tuple(mod_name.split(".")) if mod_name else ()
            if leaf == "weight" and isinstance(module, (Embedding, SNEmbedding)):
                flax_leaf, to_flax = "embedding", (lambda a: a)
            elif leaf == "weight" and isinstance(module, LayerNorm):
                flax_leaf, to_flax = "scale", (lambda a: a)
            elif leaf == "weight" and p.ndim == 4:
                flax_leaf, to_flax = "kernel", (lambda a: a.transpose(2, 3, 1, 0))
            elif leaf == "weight" and p.ndim == 2:
                flax_leaf, to_flax = "kernel", (lambda a: a.T)
            elif leaf in ("bias", "gain", "gamma"):
                flax_leaf, to_flax = leaf, (lambda a: a)
            else:
                raise KeyError(f"parameter {mod_name}.{leaf} has no flax counterpart")
            layout[f"{mod_name}.{leaf}" if mod_name else leaf] = (path + (flax_leaf,), to_flax)
    return layout


def _host(tensor) -> np.ndarray:
    return tensor.detach().to("cpu", torch.float32).numpy()


def _set(tree: dict, path: tuple, value):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def params_to_flax(model: torch.nn.Module, tensors: Mapping) -> dict:
    """A flax params tree (numpy, flax layout) from ``{parameter name:
    tensor}`` of ``model``'s parameters: the weights themselves or any
    per-parameter tensors of their shape (Adam's moments)."""
    layout = _flax_param_layout(model)
    if set(tensors) != set(layout):
        raise KeyError(f"expected the parameters of {type(model).__name__}: missing "
                       f"{sorted(set(layout) - set(tensors))[:8]}, unknown "
                       f"{sorted(set(tensors) - set(layout))[:8]}")
    tree: dict = {}
    for name, tensor in tensors.items():
        path, to_flax = layout[name]
        _set(tree, path, np.array(to_flax(_host(tensor)), order="C"))
    return tree


def params_from_flax(model: torch.nn.Module, tree: Mapping) -> dict:
    """``{parameter name: numpy array}`` in the port's layout from a flax
    params tree of ``model``; raises on a missing, unused or misshapen leaf."""
    out = _state_from_flax({"params": tree}, None, type(model).__name__)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    if set(out) != set(shapes):
        raise KeyError(f"params tree does not fit the port's {type(model).__name__}: "
                       f"missing {sorted(set(shapes) - set(out))[:8]}, unused "
                       f"{sorted(set(out) - set(shapes))[:8]}")
    bad = [n for n in out if out[n].shape != shapes[n]]
    if bad:
        raise ValueError("shape mismatch: " + ", ".join(
            f"{n} {out[n].shape} vs {shapes[n]}" for n in bad[:8]))
    return out


def _state_to_flax(model: torch.nn.Module) -> dict:
    params = {n: p for n, p in model.named_parameters()}
    state: dict = {}
    for name, tensor in model.state_dict().items():
        if name in params:
            continue
        *path, leaf = name.split(".")
        collection = ("spectral" if leaf in ("u", "sv") else
                      "batch_stats" if leaf in ("mean", "var", "accumulation_counter") else None)
        if collection is None:
            raise KeyError(f"buffer {name} has no flax counterpart")
        _set(state.setdefault(collection, {}), tuple(path) + (leaf,),
             np.array(_host(tensor), order="C"))
    return {"params": params_to_flax(model, params), "state": state}


def generator_state_to_flax(model: torch.nn.Module) -> dict:
    """The JAX package's ``{"params", "state"}`` variables (numpy, flax
    layout) of the port's Generator: the inverse of
    ``generator_state_from_flax``."""
    return _state_to_flax(model)


def discriminator_state_to_flax(model: torch.nn.Module) -> dict:
    """The JAX package's ``{"params", "state"}`` variables of the port's
    Discriminator: the inverse of ``discriminator_state_from_flax``."""
    return _state_to_flax(model)


def optimizer_state_to_flax(opt, model: torch.nn.Module) -> dict:
    """The optax state tree (numpy) of ``opt``, an ``OptaxAdam`` over
    ``model``'s parameters, in the layout of the module docstring."""
    names = {id(p): n for n, p in model.named_parameters()}
    inner = {"count": np.array(opt.count, np.int32)}
    for moment in opt.moment_names:
        inner[moment] = params_to_flax(
            model, {names[id(p)]: opt.state[p][moment] for p in opt.params})
    tree = {"0": inner, "1": {"count": np.array(opt.sched_count, np.int32)}}
    return {"0": {}, "1": tree} if opt.clip_norm is not None else tree


def optimizer_state_from_flax(opt, model: torch.nn.Module, tree: Mapping):
    """Load the optax state tree ``tree`` into ``opt`` (an ``OptaxAdam`` over
    ``model``'s parameters). Raises ``KeyError`` when the tree's structure is
    not ``opt``'s (another variant, clip or schedule wrapper) and leaves
    ``opt`` untouched then."""
    if opt.clip_norm is not None:
        if set(tree) != {"0", "1"} or tree["0"] != {}:
            raise KeyError("expected the clip_by_global_norm chain {'0': {}, '1': ...}")
        tree = tree["1"]
    if set(tree) != {"0", "1"} or not isinstance(tree["1"], Mapping) \
            or set(tree["1"]) != {"count"}:
        raise KeyError("expected {'0': moments, '1': {'count'}} (the scheduled optimizer)")
    inner = tree["0"]
    if not isinstance(inner, Mapping) or set(inner) != {"count", *opt.moment_names}:
        raise KeyError(f"expected the moments {{'count', {', '.join(opt.moment_names)}}} "
                       f"of {opt.variant}, found {sorted(inner) if isinstance(inner, Mapping) else inner}")
    by_id = {id(p): n for n, p in model.named_parameters()}
    if {id(p) for p in opt.params} != set(by_id):
        raise ValueError("the optimizer's parameters are not the model's")
    arrays = {m: params_from_flax(model, inner[m]) for m in opt.moment_names}
    with torch.no_grad():
        for p in opt.params:
            for m in opt.moment_names:
                opt.state[p][m].copy_(torch.from_numpy(np.asarray(arrays[m][by_id[id(p)]])))
    opt.count = int(inner["count"])
    opt.sched_count = int(tree["1"]["count"])
