"""The port's generator and deployment path against the JAX package.

The tiny test config (``tests/helpers.py``) with the flagship's RRM proxy,
rdof and fused attention. JAX's forward takes its Pallas kernel through the
interpreter (``IEAGAN_PALLAS_INTERPRET=1``; the dispatch's TPU check is
patched in the test, nothing in ``ieagan_tpu`` changes), and a spy proves the
kernel ran. JAX draws rdof inside the model, so the test reads the input of
its ``linear_f`` with ``flax.linen.intercept_methods`` and hands the last
``rdof_dim`` columns to the port. Inputs come from ``np.random.default_rng``.

Tolerance 1e-4 abs on the tanh output: f32 on both sides through about a
dozen convolutions and normalizations whose sums run in different orders.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import ieagan_tpu.ops.pallas as pallas_ops
from ieagan_tpu.deploy.inference import Model as JaxModel
from ieagan_tpu.models.generator import Generator as JaxGenerator
from ieagan_tpu.ops.image_norm import generate_postprocess as jax_postprocess
from ieagan_tpu.ops.rrm import RelationalReasoning as JaxRRM
from ieagan_tpu.ops.spectral import Dense
from ieagan_torch.deploy import Model, generate, generate_batched, generate_block
from ieagan_torch.models.generator import Generator
from ieagan_torch.ops.image_norm import generate_postprocess
from tests.helpers import tiny_config
from tests.test_torch_primitives import carry

CONFIG = tiny_config(RRM_prx_G=True, rdof_dim=4, use_pallas_attention=True,
                     compute_dtype="float32")
TANH_ATOL = 1e-4
CHECKPOINT = "artifacts/flagship_r4b"


@pytest.fixture
def pallas_interpreter(monkeypatch):
    """Route the JAX package's attention through its Pallas kernel in
    interpret mode, and count the kernel's calls."""
    monkeypatch.setenv("IEAGAN_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(pallas_ops, "flash_attention_available", lambda: True)
    calls = []
    real = pallas_ops.flash_attention

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(pallas_ops, "flash_attention", spy)
    return calls


def _randomize(variables, rng):
    """Random biases and running stats, so every carried leaf matters."""
    def perturb(path, leaf):
        name = path[-1].key
        if name == "bias":
            return jnp.asarray(rng.standard_normal(leaf.shape) * 0.1, jnp.float32)
        if name == "mean":
            return jnp.asarray(rng.standard_normal(leaf.shape) * 0.1, jnp.float32)
        if name == "var":
            return jnp.asarray(rng.uniform(0.5, 1.5, leaf.shape), jnp.float32)
        return leaf
    return jax.tree_util.tree_map_with_path(perturb, variables)


def _jax_forward(module, variables, z, y, rdof_key, rdof=None):
    """JAX generator output and the rdof it used. With ``rdof``, the last
    rdof_dim columns of linear_f's input are rewritten to it."""
    seen = {}

    def interceptor(next_fun, args, kwargs, context):
        if context.module.name == "linear_f" and context.method_name == "__call__":
            x = args[0]
            if rdof is not None:
                x = x.at[:, -rdof.shape[1]:].set(jnp.asarray(rdof))
            seen["rdof"] = np.asarray(x[:, -module.rdof_dim:])
            args = (x,) + tuple(args[1:])
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(interceptor):
        out = module.apply(variables, jnp.asarray(z), jnp.asarray(y), train=False,
                           rngs={"rdof": rdof_key})
    return np.asarray(out), seen["rdof"]


@pytest.fixture(scope="module")
def tiny():
    """JAX tiny generator variables, latents for two events, labels."""
    module = JaxGenerator.from_config(CONFIG, dtype=jnp.float32)
    es = CONFIG["n_classes"]
    rng = np.random.default_rng(0)
    z = rng.standard_normal((2 * es, CONFIG["dim_z"])).astype(np.float32)
    y = np.tile(np.arange(es, dtype=np.int32), 2)
    variables = module.init({"params": jax.random.PRNGKey(0),
                             "rdof": jax.random.PRNGKey(1)}, jnp.asarray(z),
                            jnp.asarray(y), train=False)
    return module, _randomize(dict(variables), rng), z, y


def test_tiny_generator_matches_jax_through_pallas(tiny, pallas_interpreter):
    module, variables, z, y = tiny
    want, rdof = _jax_forward(module, variables, z, y, jax.random.PRNGKey(7))
    assert len(pallas_interpreter) == 1, "JAX forward did not reach the Pallas kernel"
    port = carry(Generator.from_config(CONFIG), variables).eval()
    with torch.no_grad():
        got = port(torch.tensor(z), torch.tensor(y).long(), torch.tensor(rdof))
    assert got.shape == want.shape == (8, 32, 32, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TANH_ATOL)
    # the postprocess contract, on the same input in both frameworks
    np.testing.assert_allclose(generate_postprocess(torch.tensor(want)).numpy(),
                               np.asarray(jax_postprocess(jnp.asarray(want))),
                               rtol=1e-5, atol=1e-4)


def test_tiny_model_restore_and_events_match_jax(tiny, tmp_path, pallas_interpreter):
    """The slice end to end at tiny size: a JAX checkpoint written by flax is
    restored by the port's reader and carry-over, and the port's events equal
    the JAX package's generate path on the same z and rdof (pixels within
    1e-4 of the -0.26 threshold may fall on either side and are skipped)."""
    module, variables, z, y = tiny
    path = tmp_path / "G_ema_tiny.msgpack"
    params = variables["params"]
    state = {k: v for k, v in variables.items() if k != "params"}
    path.write_bytes(serialization.to_bytes({"params": params, "state": state}))
    jax_model = JaxModel(config=CONFIG, params=params, state=state, dtype=jnp.float32)
    imgs, rdof = _jax_forward(jax_model.module, variables, z, y, jax.random.PRNGKey(3))
    want = np.asarray(jax_postprocess(jnp.asarray(imgs)))

    model = Model.restore(str(path), config=CONFIG, device="cpu")
    got = model.events(torch.tensor(z), torch.tensor(rdof)).numpy()
    assert got.shape == want.shape == (8, 26, 32)
    near = np.abs(imgs[:, 3:-3, :, 0] + 0.26) < TANH_ATOL
    assert near.mean() < 0.01
    np.testing.assert_allclose(got[~near], want[~near], rtol=1e-4, atol=1e-3)


def test_generate_entry_points_are_seeded_and_consistent():
    """generate / generate_batched / generate_block on the CPU: shapes, ADU
    range, reproducibility from an explicit torch.Generator, and a block
    equal to its chunks drawn in sequence."""
    model = Model(config=CONFIG, device="cpu", seed=3)
    es = model.event_size
    one = generate(model, torch.Generator().manual_seed(1))
    assert isinstance(one, np.ndarray) and one.shape == (es, 26, 32)
    assert np.isfinite(one).all() and one.min() >= 0 and one.max() <= 255
    np.testing.assert_array_equal(one, generate(model, torch.Generator().manual_seed(1)))
    g = torch.Generator().manual_seed(2)
    chunks = [generate_batched(model, 2, g) for _ in range(3)]
    block = generate_block(model, 2, 3, torch.Generator().manual_seed(2))
    assert block.shape == (3 * 2 * es, 26, 32)
    torch.testing.assert_close(block, torch.cat(chunks), rtol=0, atol=0)


def test_model_random_init_is_deterministic_and_different_per_seed():
    a, b, c = (Model(config=CONFIG, device="cpu", seed=s).G.state_dict() for s in (0, 0, 1))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["linear.weight"], c["linear.weight"])


def test_flagship_rrm_with_best0_weights(pallas_interpreter):
    """G's RRM at flagship width (3 events x 40 sensors x 128, 2 heads of 64)
    with the real best0 weights, against JAX through the Pallas interpreter.
    1e-5: one encoder block in f32."""
    with open(f"{CHECKPOINT}/G_ema_best0.msgpack", "rb") as fp:
        tree = serialization.msgpack_restore(fp.read())
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 40, 128)).astype(np.float32)
    jmod = JaxRRM(num_layers=1, input_dim=128, num_heads=2, dim_feedforward=128,
                  which_linear=Dense, use_pallas=True)
    want = np.asarray(jmod.apply({"params": tree["params"]["RR_G"]}, jnp.asarray(x)))
    assert pallas_interpreter == [(3, 2, 40, 64)]
    rr_g = Model.restore(CHECKPOINT, tag="best0", device="cpu").G.RR_G
    with torch.no_grad():
        got = rr_g(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_bfloat16_compute_keeps_f32_parameters():
    """dtype=bfloat16 computes activations in bf16 with f32 parameters (the
    JAX package's policy). bf16 rounds each of about a dozen layers to 2**-8
    relative and batch norm rescales the error, so the tanh output is held
    to the f32 model by its mean (1e-2) and its worst pixel (0.25)."""
    f32 = Model(config=CONFIG, device="cpu", seed=5)
    bf16 = Model(config=CONFIG, device="cpu", seed=5, dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in bf16.G.parameters())
    z, rdof = f32.draw(2, torch.Generator().manual_seed(0))
    with torch.inference_mode():
        want = f32.G(z, f32.labels(2), rdof)
        got = bf16.G(z.bfloat16(), bf16.labels(2), rdof.bfloat16())
    assert got.dtype == torch.bfloat16
    diff = (got.float() - want).abs()
    assert diff.mean() < 1e-2 and diff.max() < 0.25, (diff.mean(), diff.max())
    events = bf16.events(z.bfloat16(), rdof.bfloat16())
    assert events.dtype == torch.float32 and torch.isfinite(events).all()
