"""The reference PyTorch layout (``.pth``) in and out of the port, held to the
JAX package's own converter in both directions (the reference code is not in
the repository, so neither side runs the reference model):

  * the port's ``generator_state_to_torch`` dict, read by the JAX package's
    ``convert_torch_generator`` and ``load_into_variables``, gives the JAX
    generator the port's forward;
  * the JAX package's ``export_generator_to_torch``, with the port's dict as
    its template, gives a dict that ``Model.from_torch`` turns into the JAX
    forward (< 5e-4 on the tanh output, the bound of
    ``ieagan_tpu/deploy/inference.py:166-167``);
  * ``export_torch`` then ``from_torch`` gives the same state dict bit for
    bit, and the same events.

The tiny config with two blocks per stage (so block indices and stage-final
attention are mapped as the reference nests them), G's RRM and SA at the 16
stage, in f32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ieagan_tpu.models import Generator as JaxG
from ieagan_tpu.models.convert import (convert_torch_generator, export_generator_to_torch,
                                       load_into_variables)
from ieagan_torch.deploy import Model
from ieagan_torch.models.convert import (generator_state_from_torch,
                                         generator_state_to_flax, generator_state_to_torch)
from tests.helpers import tiny_config
from tests.test_torch_generator import _jax_forward

CONFIG = tiny_config(G_depth=2, G_attn="16", RRM_prx_G=True, rdof_dim=4,
                     compute_dtype="float32")
TANH_ATOL = 5e-4


@pytest.fixture(scope="module")
def tiny():
    """A randomly initialized port Model (random biases and running stats
    too), latents for two events, labels, the JAX generator."""
    model = Model(config=CONFIG, device="cpu", seed=3)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for name, t in model.G.state_dict().items():
            if name.endswith(("bias", "mean", "gamma")):
                t.copy_(torch.tensor(rng.standard_normal(t.shape) * 0.1 + 0.3 * name.endswith(
                    "gamma"), dtype=torch.float32))
            elif name.endswith(".var"):
                t.copy_(torch.tensor(rng.uniform(0.5, 1.5, t.shape), dtype=torch.float32))
    es = CONFIG["n_classes"]
    z = rng.standard_normal((2 * es, CONFIG["dim_z"])).astype(np.float32)
    rdof = rng.standard_normal((2 * es, 4)).astype(np.float32)
    y = np.tile(np.arange(es, dtype=np.int32), 2)
    return model, z, rdof, y, JaxG.from_config(CONFIG)


def _port_forward(model, z, rdof, y):
    with torch.no_grad():
        return model.G(torch.tensor(z), torch.tensor(y).long(), torch.tensor(rdof)).numpy()


def _jax_variables(module, z, y):
    return module.init({"params": jax.random.PRNGKey(0), "rdof": jax.random.PRNGKey(1)},
                       jnp.asarray(z), jnp.asarray(y), train=False)


def test_reference_keys(tiny):
    """The reference's names: blocks.<k>.0 per block, stage attention at
    blocks.<k>.1 of the stage's last block, output_layer.{0,2}, the RRM's
    layers.<i> and linear_net.{0,3}, u0/sv0, stored_mean/var; no counters."""
    sd = generator_state_to_torch(tiny[0].G)
    assert "blocks.3.1.theta.weight" in sd and "blocks.3.1.gamma" in sd  # stage 1, block 1
    assert "blocks.2.0.bn1.gain.u0" in sd and sd["blocks.2.0.bn1.gain.u0"].shape == (1, 16)
    assert sd["blocks.2.0.bn1.gain.sv0"].shape == (1,)
    assert "blocks.0.0.bn1.stored_mean" in sd and "output_layer.0.stored_var" in sd
    assert "output_layer.2.weight" in sd and "RR_G.layers.0.linear_net.3.weight" in sd
    assert "RR_G.layers.0.self_attn.qkv_proj.weight" in sd and "RR_G.norm.weight" in sd
    assert not [k for k in sd if "accumulation_counter" in k
                or k.startswith(("blocks_", "attn_", "output_bn", "output_conv"))]


def test_port_export_runs_in_jax(tiny):
    """The port's reference-layout dict through the JAX package's converter:
    JAX's forward equals the port's."""
    model, z, rdof, y, module = tiny
    sd = {k: v.numpy() for k, v in generator_state_to_torch(model.G).items()}
    variables = load_into_variables(dict(_jax_variables(module, z, y)),
                                    convert_torch_generator(sd, g_depth=2))
    want, _ = _jax_forward(module, variables, z, y, jax.random.PRNGKey(5), rdof)
    np.testing.assert_allclose(_port_forward(model, z, rdof, y), want, rtol=0, atol=TANH_ATOL)


def test_jax_export_loads_with_from_torch(tiny, tmp_path):
    """JAX variables exported by the JAX package into the reference layout
    (the port's dict as template) load with ``Model.from_torch`` and give the
    JAX forward; ``from_torch`` reads them all and leaves nothing unused."""
    model, z, rdof, y, module = tiny
    variables = jax.tree_util.tree_map(np.asarray, dict(_jax_variables(module, z, y)))
    template = {k: v.numpy() for k, v in generator_state_to_torch(model.G).items()}
    sd = export_generator_to_torch(variables, template, g_depth=2)
    path = tmp_path / "G.pth"
    torch.save({k: torch.from_numpy(np.asarray(v).copy()) for k, v in sd.items()}, path)
    loaded = Model.from_torch(str(path), config=CONFIG, device="cpu")
    want, _ = _jax_forward(module, variables, z, y, jax.random.PRNGKey(5), rdof)
    np.testing.assert_allclose(_port_forward(loaded, z, rdof, y), want, rtol=0, atol=TANH_ATOL)
    flax_state = generator_state_to_flax(loaded.G)
    np.testing.assert_array_equal(flax_state["params"]["attn_1"]["theta"]["kernel"],
                                  variables["params"]["attn_1"]["theta"]["kernel"])


def test_export_then_from_torch_is_bit_exact(tiny, tmp_path):
    model, z, rdof, y, _ = tiny
    path = model.export_torch(str(tmp_path / "G.pth"))
    back = Model.from_torch(path, config=CONFIG, device="cpu")
    want = model.G.state_dict()
    got = back.G.state_dict()
    assert set(got) == set(want)
    for name, value in want.items():
        assert torch.equal(got[name], value), name
    gen = lambda: torch.Generator().manual_seed(4)
    from ieagan_torch.deploy import generate_batched
    torch.testing.assert_close(generate_batched(back, 2, gen()), generate_batched(model, 2, gen()),
                               rtol=0, atol=0)


def test_from_torch_refuses_what_does_not_fit(tiny, tmp_path):
    """A pickled module is refused with a message (the file is read with
    weights_only=True); an unknown key, a missing key and a wrong shape
    raise."""
    model = tiny[0]
    path = tmp_path / "module.pth"
    torch.save(torch.nn.Linear(2, 2), path)
    with pytest.raises(ValueError, match="state dict"):
        Model.from_torch(str(path), config=CONFIG, device="cpu")
    sd = generator_state_to_torch(model.G)
    template = model.G.state_dict()
    with pytest.raises(KeyError, match="no counterpart"):
        generator_state_from_torch(dict(sd, **{"blocks.0.0.bn1.running_mean": torch.zeros(4)}), 2,
                                   template)
    with pytest.raises(KeyError, match="missing"):
        generator_state_from_torch({k: v for k, v in sd.items() if k != "linear.weight"}, 2,
                                   template)
    with pytest.raises(ValueError, match="shape mismatch"):
        generator_state_from_torch(dict(sd, **{"linear.weight": torch.zeros(3, 3)}), 2, template)


def test_several_singular_vectors_round_trip():
    """num_G_SVs = 2: u0 and u1 (and sv0, sv1) stack into the port's u."""
    model = Model(config=dict(CONFIG, num_G_SVs=2), device="cpu", seed=1)
    sd = generator_state_to_torch(model.G)
    assert sd["linear.u1"].shape == (1, sd["linear.u0"].shape[1])
    back = generator_state_from_torch(sd, 2, model.G.state_dict())
    for name, value in model.G.state_dict().items():
        np.testing.assert_array_equal(back[name], value.numpy(), err_msg=name)
