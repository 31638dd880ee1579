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
    bit, and the same events;
  * the discriminator likewise, against ``convert_torch_discriminator`` and
    ``export_discriminator_to_torch`` (forwards within 1e-4, the whole tiny
    D's bound in ``tests/test_torch_discriminator.py``), the round trip bit
    for bit;
  * the reference's ``torch.optim.Adam`` state dict for G and D against
    ``export_adam_to_torch`` and ``convert_torch_adam``: moments bit for
    bit, the same counts, a state stepped by torch itself read as JAX reads
    it, the round trip bit for bit, AMSGrad and AdaBelief refused.

The tiny config with two blocks per stage (so block indices and stage-final
attention are mapped as the reference nests them), G's RRM and SA at the 16
stage, in f32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from ieagan_tpu.models import Discriminator as JaxD
from ieagan_tpu.models import Generator as JaxG
from ieagan_tpu.models.convert import (convert_torch_adam, convert_torch_discriminator,
                                       convert_torch_generator, export_adam_to_torch,
                                       export_discriminator_to_torch, export_generator_to_torch,
                                       load_into_variables)
from ieagan_tpu.models.convert import torch_param_names as jax_torch_param_names
from ieagan_tpu.train.optim import make_optimizer as jax_optimizer
from ieagan_torch.deploy import Model
from ieagan_torch.models.convert import (discriminator_state_from_torch,
                                         discriminator_state_to_flax,
                                         discriminator_state_to_torch,
                                         generator_state_from_torch, generator_state_to_flax,
                                         generator_state_to_torch, optimizer_state_from_torch,
                                         optimizer_state_to_flax, optimizer_state_to_torch,
                                         torch_param_names)
from ieagan_torch.models.discriminator import Discriminator
from ieagan_torch.models.generator import Generator
from ieagan_torch.train.optim import make_optimizer
from tests.helpers import tiny_config
from tests.test_torch_eval import few_torch_threads  # noqa: F401 (autouse)
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


@pytest.fixture(scope="module")
def jax_variables(tiny):
    """The JAX generator's variables from PRNGKey(0) at ``tiny``'s shapes,
    initialized once for the tests that read them."""
    _, z, _, y, module = tiny
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


def test_port_export_runs_in_jax(tiny, jax_variables):
    """The port's reference-layout dict through the JAX package's converter:
    JAX's forward equals the port's."""
    model, z, rdof, y, module = tiny
    sd = {k: v.numpy() for k, v in generator_state_to_torch(model.G).items()}
    variables = load_into_variables(dict(jax_variables),
                                    convert_torch_generator(sd, g_depth=2))
    want, _ = _jax_forward(module, variables, z, y, jax.random.PRNGKey(5), rdof)
    np.testing.assert_allclose(_port_forward(model, z, rdof, y), want, rtol=0, atol=TANH_ATOL)


def test_jax_export_loads_with_from_torch(tiny, jax_variables, tmp_path):
    """JAX variables exported by the JAX package into the reference layout
    (the port's dict as template) load with ``Model.from_torch`` and give the
    JAX forward; ``from_torch`` reads them all and leaves nothing unused."""
    model, z, rdof, y, module = tiny
    variables = jax.tree_util.tree_map(np.asarray, dict(jax_variables))
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


# ------------------------------------------------ the discriminator and Adam

D_CONFIG = tiny_config(D_depth=2, D_attn="16", RRM_prx_D=True, compute_dtype="float32")
D_TOL = 1e-4  # the whole tiny D against JAX (tests/test_torch_discriminator.py)


@pytest.fixture(scope="module")
def tiny_d():
    """A randomly initialized port D (random biases and SA gammas), images
    and labels of two events, the JAX discriminator."""
    D = Discriminator.from_config(D_CONFIG)
    g = torch.Generator().manual_seed(6)
    D.reset_parameters(g)
    with torch.no_grad():
        for name, p in D.named_parameters():
            if name.endswith(("bias", "gamma")):
                p.copy_(torch.randn(p.shape, generator=g) * 0.1 + 0.3)
    D.eval()
    rng = np.random.default_rng(1)
    es = D_CONFIG["n_classes"]
    x = rng.uniform(-1, 1, (2 * es, 32, 32, 1)).astype(np.float32)
    y = np.tile(np.arange(es, dtype=np.int32), 2)
    return D, x, y, JaxD.from_config(D_CONFIG)


def _d_forward(D, x, y):
    with torch.no_grad():
        return [t.numpy() for t in D(torch.tensor(x), torch.tensor(y).long())]


@pytest.fixture(scope="module")
def jax_d_forward(tiny_d):
    """The JAX discriminator's forward on ``tiny_d``'s batch, jitted once
    for the tests that run it: variables -> outputs as numpy."""
    _, x, y, module = tiny_d
    apply = jax.jit(lambda v, x, y: module.apply(v, x, y, train=False))
    return lambda variables: [np.asarray(t) for t in apply(variables, jnp.asarray(x),
                                                           jnp.asarray(y))]


def _jax_d_init(module, key, x, y):
    init = jax.jit(lambda x, y: module.init({"params": jax.random.PRNGKey(key)}, x, y,
                                            train=False))
    return init(jnp.asarray(x), jnp.asarray(y))


def test_discriminator_reference_keys(tiny_d):
    """The reference's names: blocks.<stage>.<j> per block and the stage's
    attention after its blocks at blocks.<stage>.<D_depth>, the RRMs'
    layers.<i> and linear_net.{0,3}, u0/sv0."""
    sd = discriminator_state_to_torch(tiny_d[0])
    assert "blocks.0.1.conv3.weight" in sd and "blocks.1.2.theta.weight" in sd
    assert "blocks.1.2.gamma" in sd and sd["input_conv.u0"].shape == (1, 4 * D_CONFIG["D_ch"])
    assert "RR_D.layers.0.linear_net.3.weight" in sd and "RR_Dproxy.norm.weight" in sd
    assert "RR_Dproxy.layers.0.self_attn.qkv_proj.sv0" in sd and "linear1.weight" in sd
    assert not [k for k in sd if k.startswith(("blocks_", "attn_")) or k.endswith((".u", ".sv"))]


def test_port_discriminator_export_runs_in_jax(tiny_d, jax_d_forward):
    """The port's reference-layout D through the JAX package's
    ``convert_torch_discriminator``: JAX's forward equals the port's."""
    D, x, y, module = tiny_d
    sd = {k: v.numpy() for k, v in discriminator_state_to_torch(D).items()}
    variables = load_into_variables(dict(_jax_d_init(module, 0, x, y)),
                                    convert_torch_discriminator(sd, d_depth=2))
    for got, want in zip(_d_forward(D, x, y), jax_d_forward(variables)):
        np.testing.assert_allclose(got, want, rtol=D_TOL, atol=D_TOL)


def test_jax_discriminator_export_loads_in_the_port(tiny_d, jax_d_forward):
    """JAX variables exported by ``export_discriminator_to_torch`` (the
    port's dict as template) read by ``discriminator_state_from_torch``
    give the JAX forward, and every leaf bit for bit."""
    D, x, y, module = tiny_d
    variables = jax.tree_util.tree_map(np.asarray, dict(_jax_d_init(module, 2, x, y)))
    template = {k: v.numpy() for k, v in discriminator_state_to_torch(D).items()}
    sd = export_discriminator_to_torch(variables, template, d_depth=2)
    other = Discriminator.from_config(D_CONFIG).eval()
    state = discriminator_state_from_torch(sd, 2, other.state_dict())
    other.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    for got, want in zip(_d_forward(other, x, y), jax_d_forward(variables)):
        np.testing.assert_allclose(got, want, rtol=D_TOL, atol=D_TOL)
    flax_state = discriminator_state_to_flax(other)
    np.testing.assert_array_equal(flax_state["params"]["RR_Dproxy"]["layers_0"]["linear1"][
        "kernel"], variables["params"]["RR_Dproxy"]["layers_0"]["linear1"]["kernel"])


def test_discriminator_round_trip_and_refusals(tiny_d):
    D = tiny_d[0]
    sd = discriminator_state_to_torch(D)
    template = D.state_dict()
    back = discriminator_state_from_torch(sd, 2, template)
    assert set(back) == set(template)
    for name, value in template.items():
        np.testing.assert_array_equal(back[name], value.numpy(), err_msg=name)
    with pytest.raises(KeyError, match="no counterpart"):
        discriminator_state_from_torch(dict(sd, **{"blocks.0.0.conv1.running_mean":
                                                   torch.zeros(4)}), 2, template)
    with pytest.raises(KeyError, match="missing"):
        discriminator_state_from_torch({k: v for k, v in sd.items() if k != "linear0.weight"},
                                       2, template)
    with pytest.raises(ValueError, match="shape mismatch"):
        discriminator_state_from_torch(dict(sd, **{"linear0.weight": torch.zeros(3, 3)}), 2,
                                       template)


def _adam_case(tiny, tiny_d, net):
    """The port's model of ``net``, its reference-layout export (the
    template), its flax params tree and the config's depth."""
    if net == "G":
        return tiny[0].G, generator_state_to_torch(tiny[0].G), CONFIG["G_depth"]
    return tiny_d[0], discriminator_state_to_torch(tiny_d[0]), D_CONFIG["D_depth"]


def _stepped(model, variant=None, steps=2, seed=0):
    """A fresh ``OptaxAdam`` over ``model`` after ``steps`` steps of seeded
    gradients (the weights restored afterwards)."""
    kwargs = {} if variant is None else {variant: True}
    opt = make_optimizer(model.parameters(), 0.0, 0.999, 1e-6, **kwargs)
    saved = {n: p.detach().clone() for n, p in model.named_parameters()}
    g = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        for p in model.parameters():
            p.grad = torch.randn(p.shape, generator=g)
        opt.step(1e-3)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(saved[n])
            p.grad = None
    return opt


def _to_flax_state(opt, model):
    """The port's Adam as the optax state the JAX package builds."""
    tx = jax_optimizer(1e-3, 0.0, 0.999, 1e-6)
    params = _flax_params(model)
    return serialization.from_state_dict(tx.init(params), optimizer_state_to_flax(opt, model))


def _flax_params(model):
    convert = generator_state_to_flax if isinstance(model, Generator) else \
        discriminator_state_to_flax
    return convert(model)["params"]


@pytest.mark.parametrize("net", ["G", "D"])
def test_adam_export_matches_jax(tiny, tiny_d, net):
    """``optimizer_state_to_torch`` against ``export_adam_to_torch`` on the
    same moments: the same indices, moments bit for bit, the same step."""
    model, template, depth = _adam_case(tiny, tiny_d, net)
    opt = _stepped(model)
    got = optimizer_state_to_torch(opt, model, lr=1e-3)
    want = export_adam_to_torch(_to_flax_state(opt, model),
                                {k: v.numpy() for k, v in template.items()}, which=net,
                                depth=depth)
    assert torch_param_names(model) == jax_torch_param_names(template)
    assert got["param_groups"][0]["params"] == want["param_groups"][0]["params"]
    assert set(got["state"]) == set(want["state"])
    for i, st in want["state"].items():
        assert float(got["state"][i]["step"]) == st["step"] == 2
        for k in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(got["state"][i][k].numpy(), st[k], err_msg=(i, k))


@pytest.mark.parametrize("net", ["G", "D"])
def test_adam_import_matches_jax(tiny, tiny_d, net):
    """A reference ``torch.optim.Adam`` state dict, stepped by torch itself
    over the reference layout with one parameter left without a gradient
    (no state: its moments stay zero), read by ``optimizer_state_from_torch``
    and by ``convert_torch_adam``: the same moments bit for bit and count."""
    model, template, depth = _adam_case(tiny, tiny_d, net)
    names = torch_param_names(model)
    ref = [torch.nn.Parameter(template[k].clone()) for k in names]
    adam = torch.optim.Adam(ref, lr=1e-3, betas=(0.0, 0.999), eps=1e-6)
    g = torch.Generator().manual_seed(3)
    for _ in range(3):
        for p in ref[1:]:
            p.grad = torch.randn(p.shape, generator=g)
        adam.step()
    sd = adam.state_dict()
    assert 0 not in sd["state"]
    opt = make_optimizer(model.parameters(), 0.0, 0.999, 1e-6)
    opt.sched_count = 5
    optimizer_state_from_torch(opt, model, sd)
    as_np = {"state": {i: {k: v.numpy() for k, v in st.items()} for i, st in sd["state"].items()},
             "param_groups": sd["param_groups"]}
    tx = jax_optimizer(1e-3, 0.0, 0.999, 1e-6)
    params = _flax_params(model)
    want = serialization.to_state_dict(convert_torch_adam(
        as_np, {k: v.numpy() for k, v in template.items()}, params, tx.init(params),
        which=net, depth=depth))
    got = optimizer_state_to_flax(opt, model)
    assert (opt.count, opt.sched_count) == (3, 5)
    assert int(want["0"]["count"]) == 3
    for moment in ("mu", "nu"):
        flat_got = dict(jax.tree_util.tree_flatten_with_path(got["0"][moment])[0])
        flat_want = dict(jax.tree_util.tree_flatten_with_path(
            jax.tree_util.tree_map(np.asarray, want["0"][moment]))[0])
        assert flat_got.keys() == flat_want.keys()
        for path, value in flat_want.items():
            np.testing.assert_array_equal(flat_got[path], value, err_msg=str(path))
    first = dict(model.named_parameters())
    zero = [n for n, p in first.items() if not bool(opt.state[p]["mu"].any())]
    assert len(zero) == 1


@pytest.mark.parametrize("net", ["G", "D"])
def test_adam_round_trip_is_bit_exact(tiny, tiny_d, net):
    """Port -> reference -> port gives the moments and count bit for bit,
    and ``torch.optim.Adam`` loads the reference dict and steps."""
    model, template, _ = _adam_case(tiny, tiny_d, net)
    opt = _stepped(model, seed=4)
    sd = optimizer_state_to_torch(opt, model, lr=1e-3)
    fresh = make_optimizer(model.parameters(), 0.0, 0.999, 1e-6)
    optimizer_state_from_torch(fresh, model, sd)
    assert fresh.count == opt.count == 2
    for p in model.parameters():
        for m in ("mu", "nu"):
            assert torch.equal(fresh.state[p][m], opt.state[p][m])
    ref = [torch.nn.Parameter(template[k].clone()) for k in torch_param_names(model)]
    adam = torch.optim.Adam(ref)
    adam.load_state_dict(sd)
    assert adam.param_groups[0]["betas"] == (0.0, 0.999) and adam.param_groups[0]["lr"] == 1e-3
    for p in ref:
        p.grad = torch.zeros_like(p)
    adam.step()
    assert float(adam.state[ref[0]]["step"]) == 3


@pytest.mark.parametrize("variant", ["amsgrad", "ada_belief"])
def test_adam_interop_refuses_amsgrad_and_adabelief(tiny_d, variant):
    D = tiny_d[0]
    opt = _stepped(D, variant=variant, steps=1)
    with pytest.raises(ValueError, match="torch.optim.Adam"):
        optimizer_state_to_torch(opt, D, lr=1e-3)
    adam_sd = optimizer_state_to_torch(_stepped(D, steps=1), D, lr=1e-3)
    with pytest.raises(ValueError, match="torch.optim.Adam"):
        optimizer_state_from_torch(opt, D, adam_sd)
    ams = dict(adam_sd, param_groups=[dict(adam_sd["param_groups"][0], amsgrad=True)])
    with pytest.raises(ValueError, match="AMSGrad"):
        optimizer_state_from_torch(make_optimizer(D.parameters(), 0.0, 0.999, 1e-6), D, ams)
