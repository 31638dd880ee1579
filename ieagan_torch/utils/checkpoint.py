"""Reading the weights of a training checkpoint of the JAX package (the G, D
and G_ema part of ``ieagan_tpu/utils/checkpoint.py::load_checkpoint``).

A run's weights dir holds, per tag (``copy<N>``, ``best<N>``), one
flax-msgpack file per component (``G_<tag>``, ``D_<tag>``, ``G_ema_<tag>``,
``G_optim_<tag>``, ``D_optim_<tag>``) and ``state_dict_<tag>.json`` with the
iteration. This reads the three weight components with the port's own msgpack
reader and no optimizer file: resuming the Adam moments is not ported yet.
"""

from __future__ import annotations

import json
import os

from ieagan_torch.utils.flax_msgpack import read_checkpoint

WEIGHT_COMPONENTS = ("G", "D", "G_ema")


def load_train_weights(path: str, tag: str) -> dict:
    """``{"G", "D", "G_ema"}`` flax variable trees (nested dicts of numpy
    arrays) and ``"itr"`` (int) of checkpoint ``tag`` under ``path``."""
    out = {}
    for base in WEIGHT_COMPONENTS:
        out[base] = read_checkpoint(os.path.join(path, f"{base}_{tag}.msgpack"))
    with open(os.path.join(path, f"state_dict_{tag}.json"), encoding="utf-8") as fp:
        out["itr"] = int(json.load(fp).get("itr", 0))
    return out
