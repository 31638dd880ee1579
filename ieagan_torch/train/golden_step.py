"""Reference numbers of the JAX package's first train step from the flagship
checkpoint ``copy16000``, and the check of the port against them.

``golden_step_copy16000.json`` records, for one event of 40 images, what
``ieagan_tpu.train.make_train_step`` computes on the CPU in float32 from the
G, D and G_ema weights of ``artifacts/flagship_r4b`` tag ``copy16000`` with
fresh Adam moments and the flagship config:

  * its inputs: the seed of the real batch, y, z and rdof (all from
    ``np.random.default_rng(seed)``, see ``inputs``), and the DiffAugment
    draws the JAX step took (replayed from its key and stored);
  * the six metrics;
  * per top-level module of G and D, the L2 norm of the gradient the
    optimizer received (after ortho-reg);
  * a few hundred fixed gradient entries, by parameter name (the port's) and
    flat index in the port's layout, with the RMS of their parameter's
    gradient.

The file is written and re-checked by ``tests/test_torch_golden_step.py``;
``chip_smoke.py`` holds the port's step on the card against it.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

GOLDEN_PATH = Path(__file__).resolve().with_name("golden_step_copy16000.json")
CHECKPOINT_TAG = "copy16000"
METRICS = ("D_loss_real", "D_loss_fake", "unif_loss_d", "iea_loss", "unif_loss_g", "G_loss")
ENTRIES_PER_LEAF = 2

# Tolerances, fixed before the first comparison on the card. Both sides run
# the step in f32 (TF32 off on the card) and differ in summation order
# through G, three D passes and their backward passes.
#  * metrics: rtol 2e-3, atol 2e-5, the bound the JAX package holds its
#    step's losses to against the reference PyTorch model
#    (tests/test_model_parity.py);
#  * module gradient norms: 1e-2 relative, that test's bound on the worst
#    per-leaf gradient error;
#  * gradient entries: 5e-2 of the RMS of their parameter's gradient (a leaf
#    within 1e-2 in norm may hold single entries a few times further off).
METRIC_RTOL, METRIC_ATOL = 2e-3, 2e-5
NORM_RTOL = 1e-2
ENTRY_RMS_TOL = 5e-2


def load() -> dict:
    with open(GOLDEN_PATH, encoding="utf-8") as fp:
        return json.load(fp)


def inputs(seed: int, event_size: int = 40, resolution: int = 256, width: int = 768,
           dim_z: int = 128, rdof_dim: int = 4):
    """The golden step's real batch x (B, H, W, 1) uniform in [-1, 1], labels
    y (a permutation of the sensors), and the D phase's and the G phase's
    (z, rdof), as numpy arrays, drawn in that order."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, (event_size, resolution, width, 1)).astype(np.float32)
    y = rng.permutation(event_size).astype(np.int32)
    latents = [(rng.standard_normal((event_size, dim_z), dtype=np.float32),
                rng.standard_normal((event_size, rdof_dim), dtype=np.float32))
               for _ in range(2)]
    return x, y, latents


def draw_schedule(golden: dict) -> list:
    """The port's ``draw_schedule`` for the golden step: D phase z, rdof, the
    fakes' and the reals' DiffAugment draws; G phase z, rdof, the fakes'."""
    _, _, latents = inputs(golden["seed"])
    d_fake, d_real, g_fake = ({k: np.asarray(v) for k, v in d.items()}
                              for d in golden["draws"])
    (z_d, rdof_d), (z_g, rdof_g) = latents
    return [z_d, rdof_d, d_fake, d_real, z_g, rdof_g, g_fake]


def module_norms(grads: dict) -> dict:
    """L2 norm of the gradient per top-level module (the first name part)."""
    sums: dict[str, float] = {}
    for name, g in grads.items():
        top = name.split(".")[0]
        sums[top] = sums.get(top, 0.0) + float(np.sum(np.square(np.asarray(g, np.float64))))
    return {k: float(np.sqrt(v)) for k, v in sums.items()}


def choose_entries(grads: dict, net: str, seed: int) -> list:
    """``[net, name, flat index, rms]`` for ENTRIES_PER_LEAF fixed entries of
    every parameter whose gradient is not null (norm >= 1e-5)."""
    rng = np.random.default_rng(seed)
    out = []
    for name in sorted(grads):
        g = np.asarray(grads[name], np.float64).ravel()
        if np.linalg.norm(g) < 1e-5:
            continue
        rms = float(np.sqrt(np.mean(g * g)))
        for i in rng.integers(0, g.size, ENTRIES_PER_LEAF):
            out.append([net, name, int(i), rms])
    return out


def summarize(metrics: dict, grads: dict, entries: list) -> dict:
    """``metrics`` (name -> float), ``grads`` ({"G", "D"} -> name -> array in
    the port's layout) as the golden file stores them, at ``entries``."""
    return {
        "metrics": {k: float(metrics[k]) for k in METRICS},
        "module_norms": {net: module_norms(grads[net]) for net in ("G", "D")},
        "entries": [float(np.asarray(grads[net][name]).ravel()[i])
                    for net, name, i, _ in entries],
    }


def compare(golden: dict, summary: dict) -> dict:
    """Worst differences of ``summary`` from ``golden`` and whether each is
    within its tolerance."""
    m_err = max(abs(summary["metrics"][k] - golden["metrics"][k])
                - METRIC_RTOL * abs(golden["metrics"][k]) for k in METRICS)
    m_rel = max(abs(summary["metrics"][k] - golden["metrics"][k])
                / max(abs(golden["metrics"][k]), 1e-12) for k in METRICS)
    n_rel = max(abs(summary["module_norms"][net][k] - v) / max(v, 1e-12)
                for net in ("G", "D") for k, v in golden["module_norms"][net].items())
    e_err = max(abs(s - w) / rms for s, w, (_, _, _, rms)
                in zip(summary["entries"], golden["entries_values"], golden["entries"]))
    return {
        "metrics_max_rel": m_rel, "metrics_ok": m_err <= METRIC_ATOL,
        "module_norm_max_rel": n_rel, "module_norm_ok": n_rel <= NORM_RTOL,
        "entry_max_err_over_rms": e_err, "entries_ok": e_err <= ENTRY_RMS_TOL,
    }
