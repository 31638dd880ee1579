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

``generator_state_from_torch`` and ``generator_state_to_torch`` map the
port's Generator onto the reference PyTorch layout (reference:
model.py:139-487), as ``ieagan_tpu/models/convert.py:31-133`` and
``:191-263`` do for the JAX package::

  blocks.<k>.0.<rest>        <-> blocks_<k // G_depth>_<k % G_depth>.<rest>
  blocks.<k>.1.<rest>        <-> attn_<k // G_depth>.<rest> (k the stage's last block)
  output_layer.0 / .2        <-> output_bn / output_conv
  RR_G.layers.<i>            <-> RR_G.layers_<i>
  ...linear_net.0 / .3       <-> ...linear1 / linear2 (the RRM's feed-forward)
  <sn module>.u<i> (1, out)  <-> <sn module>.u[i]; sv<i> (1,) <-> sv[i]
  stored_mean / stored_var   <-> mean / var

Weights keep their names and layouts. The reference has no standing-stats
counters: ``accumulation_counter`` is left out of the export and read as 0.
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


def _torch_module_path(parts: list[str], g_depth: int) -> list[str]:
    """A reference-layout module path as the port's."""
    if parts[0] == "blocks":
        k, j = int(parts[1]), int(parts[2])
        name = f"blocks_{k // g_depth}_{k % g_depth}" if j == 0 else f"attn_{k // g_depth}"
        return [name] + parts[3:]
    if parts[0] == "output_layer":
        return [{"0": "output_bn", "2": "output_conv"}[parts[1]]] + parts[2:]
    out = []
    rest = list(parts)
    while rest:
        p = rest.pop(0)
        if p == "layers":
            out.append(f"layers_{rest.pop(0)}")
        elif p == "linear_net":
            out.append({"0": "linear1", "3": "linear2"}[rest.pop(0)])
        else:
            out.append(p)
    return out


def _port_module_path(parts: list[str], g_depth: int) -> list[str]:
    """A module path of the port's Generator in the reference layout."""
    head = parts[0]
    if head.startswith("blocks_"):
        stage, index = map(int, head.split("_")[1:])
        return ["blocks", str(stage * g_depth + index), "0"] + parts[1:]
    if head.startswith("attn_"):
        return ["blocks", str(int(head.split("_")[1]) * g_depth + g_depth - 1), "1"] + parts[1:]
    if head in ("output_bn", "output_conv"):
        return ["output_layer", "0" if head == "output_bn" else "2"] + parts[1:]
    out = []
    for prev, p in zip([""] + parts, parts):
        if p.startswith("layers_"):
            out += ["layers", p.split("_")[1]]
        elif prev.startswith("layers_") and p in ("linear1", "linear2"):  # the RRM's MLP
            out += ["linear_net", "0" if p == "linear1" else "3"]
        else:
            out.append(p)
    return out


def generator_state_from_torch(state_dict: Mapping, g_depth: int = 2,
                               template: Mapping | None = None) -> dict:
    """A state dict (numpy, the port's names) for the port's Generator from a
    reference-layout PyTorch Generator state dict (tensors or arrays).

    Raises ``KeyError`` on a key it cannot map. With ``template`` (the port's
    ``state_dict()``), a template key missing from the result is an error too,
    except the standing-stats counters, which the reference does not keep
    and which are read as 0; so is a converted key the template does not
    have, and a shape that differs."""
    out: dict[str, np.ndarray] = {}
    svs: dict[tuple, dict[int, np.ndarray]] = {}
    for key, value in state_dict.items():
        arr = np.asarray(value.detach().cpu().float().numpy() if hasattr(value, "detach")
                         else value, np.float32)
        *mod, leaf = key.split(".")
        path = ".".join(_torch_module_path(mod, g_depth)) if mod else ""
        for prefix, name in (("u", "u"), ("sv", "sv")):
            if leaf.startswith(prefix) and leaf[len(prefix):].isdigit():
                svs.setdefault((path, name), {})[int(leaf[len(prefix):])] = arr.reshape(-1)
                break
        else:
            leaf = {"stored_mean": "mean", "stored_var": "var"}.get(leaf, leaf)
            if leaf not in ("weight", "bias", "gain", "gamma", "mean", "var",
                            "accumulation_counter"):
                raise KeyError(f"reference key {key} has no counterpart in the port")
            out[f"{path}.{leaf}" if path else leaf] = arr
    for (path, name), parts in svs.items():
        stacked = np.stack([parts[i] for i in sorted(parts)])
        out[f"{path}.{name}"] = stacked if name == "u" else stacked.reshape(-1)
    out = {k: np.array(v, np.float32, order="C") for k, v in out.items()}
    if template is not None:
        for name, value in template.items():
            if name.endswith("accumulation_counter") and name not in out:
                out[name] = np.zeros(tuple(value.shape), np.float32)
        missing = sorted(set(template) - set(out))
        unused = sorted(set(out) - set(template))
        if missing or unused:
            raise KeyError(f"state dict does not fit the port's Generator: missing "
                           f"{missing[:8]} ({len(missing)}), unused {unused[:8]} ({len(unused)})")
        for name in out:
            want = tuple(template[name].shape)
            if out[name].shape != want:
                if out[name].size != int(np.prod(want, dtype=np.int64)):
                    raise ValueError(f"shape mismatch: {name} {out[name].shape} vs {want}")
                out[name] = out[name].reshape(want)  # the 0-d gamma, the (1,) counters
    return out


def generator_state_to_torch(model: torch.nn.Module) -> dict:
    """The reference-layout PyTorch state dict (CPU tensors) of the port's
    Generator: the inverse of ``generator_state_from_torch``. ``u`` of shape
    (num_svs, out) becomes ``u0``.. of shape (1, out), ``sv`` ``sv0``.. of
    shape (1,)."""
    g_depth = sum(1 for name in model.layer_names if name.startswith("blocks_0_"))
    out = {}
    for name, tensor in model.state_dict().items():
        *mod, leaf = name.split(".")
        if leaf == "accumulation_counter":
            continue
        key = ".".join(_port_module_path(mod, g_depth)) if mod else ""
        value = tensor.detach().to("cpu", torch.float32).clone()
        if leaf in ("u", "sv"):
            for i, row in enumerate(value):
                out[f"{key}.{leaf}{i}"] = row.reshape(1, -1) if leaf == "u" else row.reshape(1)
            continue
        leaf = {"mean": "stored_mean", "var": "stored_var"}.get(leaf, leaf)
        out[f"{key}.{leaf}" if key else leaf] = value
    return out
