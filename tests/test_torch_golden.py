"""The golden file of the flagship ``best0`` event (``ieagan_torch/deploy/
golden_best0.json``), which ``chip_smoke.py`` holds the port's event on the
card against.

The JAX side runs ``Model.restore("artifacts/flagship_r4b", tag="best0")``
on the CPU at full width (one event, 2-3 minutes); the golden rdof enters it
by rewriting the last ``rdof_dim`` columns of ``linear_f``'s input in an
interceptor, since the JAX model draws rdof itself. Those tests are slow.

Write the file anew with ``python tests/test_torch_golden.py --write``.
"""

import json
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ieagan_torch.deploy import golden

CHECKPOINT = "artifacts/flagship_r4b"


def jax_event(seed: int):
    """The JAX package's tanh output (40, 256, 768, 1) and event
    (40, 250, 768) for the golden inputs."""
    from ieagan_tpu.deploy.inference import Model
    from ieagan_tpu.ops.image_norm import generate_postprocess

    model = Model.restore(CHECKPOINT, tag="best0")
    z, rdof = golden.inputs(seed, event_size=model.event_size,
                            dim_z=model.config["dim_z"],
                            rdof_dim=model.config["rdof_dim"])
    y = jnp.arange(model.event_size, dtype=jnp.int32)

    def interceptor(next_fun, args, kwargs, context):
        if context.module.name == "linear_f" and context.method_name == "__call__":
            args = (args[0].at[:, -rdof.shape[1]:].set(jnp.asarray(rdof)),) + tuple(args[1:])
        return next_fun(*args, **kwargs)

    @jax.jit
    def forward(params, state):
        with nn.intercept_methods(interceptor):
            return model.module.apply({"params": params, **state}, jnp.asarray(z), y,
                                      train=False, rngs={"rdof": jax.random.PRNGKey(0)})

    tanh = forward(model.params, model.state)
    return np.asarray(tanh), np.asarray(generate_postprocess(tanh))


def build_golden(seed: int = 0) -> dict:
    tanh, events = jax_event(seed)
    index = golden.pixel_index(seed, tanh.shape[:3])
    return {"seed": seed, "checkpoint": f"{CHECKPOINT} best0 (G_ema)",
            "index": index.tolist(), **golden.summarize(tanh, events, index)}


def test_golden_file_is_well_formed():
    g = golden.load()
    assert g["seed"] == 0
    assert len(g["adu_sum"]) == len(g["nonzero"]) == 40
    index = np.asarray(g["index"])
    np.testing.assert_array_equal(index, golden.pixel_index(g["seed"], (40, 256, 768)))
    assert len(g["tanh"]) == len(index)
    assert all(-1 <= t <= 1 for t in g["tanh"])
    assert all(0 <= n <= 250 * 768 for n in g["nonzero"])
    assert golden.compare(g, g) == {
        "tanh_max_abs": 0.0, "tanh_ok": True, "adu_sum_max_rel": 0.0,
        "adu_sum_ok": True, "nonzero_max_abs": 0, "nonzero_ok": True}


def test_compare_flags_each_kind_of_difference():
    g = golden.load()
    off = dict(g, tanh=[t + 2 * golden.TANH_ATOL for t in g["tanh"]],
               adu_sum=[s * (1 + 2 * golden.ADU_SUM_RTOL) for s in g["adu_sum"]],
               nonzero=[n + golden.NONZERO_ATOL + 1 for n in g["nonzero"]])
    result = golden.compare(g, off)
    assert not (result["tanh_ok"] or result["adu_sum_ok"] or result["nonzero_ok"])


@pytest.mark.slow
def test_golden_file_matches_jax():
    """Regenerate the golden numbers from the JAX package and check the file."""
    g = golden.load()
    fresh = build_golden(g["seed"])
    assert fresh["index"] == g["index"]
    result = golden.compare(g, fresh)
    assert result["tanh_max_abs"] <= 1e-6 and result["adu_sum_max_rel"] <= 1e-6, result
    assert result["nonzero_max_abs"] == 0, result


@pytest.mark.slow
def test_port_cpu_event_matches_golden():
    """The port on the CPU at full width, with the golden inputs, within the
    tolerances the card is held to."""
    from ieagan_torch.deploy import Model
    g = golden.load()
    model = Model.restore(CHECKPOINT, tag="best0", device="cpu")
    z, rdof = golden.inputs(g["seed"])
    with torch.inference_mode():
        tanh = model.G(torch.tensor(z), model.labels(1), torch.tensor(rdof))
        events = model.events(torch.tensor(z), torch.tensor(rdof))
    summary = golden.summarize(tanh.numpy(), events.numpy(), np.asarray(g["index"]))
    result = golden.compare(g, summary)
    print(result)
    assert result["tanh_ok"] and result["adu_sum_ok"] and result["nonzero_ok"], result


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        raise SystemExit("usage: python tests/test_torch_golden.py --write")
    jax.config.update("jax_platforms", "cpu")
    data = build_golden(0)
    with open(golden.GOLDEN_PATH, "w", encoding="utf-8") as fp:
        json.dump(data, fp, separators=(",", ":"))
        fp.write("\n")
    print(f"wrote {golden.GOLDEN_PATH}")
