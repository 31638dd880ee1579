"""The model, loss and step options the flagship leaves off, in the port
against the JAX package, with the same weights and the same numpy-seeded
inputs.

Weights reach the port through its own carry-over (``models/convert.py``),
so these tests also hold the flax layout of every new leaf. The JAX
package's attention takes its Pallas kernel in interpret mode where
``use_pallas_attention`` is on (``tests/test_torch_generator.py``), the port
the kernels' plain versions. The prior table (``ops/prior.py``) is module
state in both packages; the tests set the same seeded table in both.

JAX's generator with ``G_param != "SN"`` raises ``TypeError``: it calls
flax's ``nn.Conv`` with the ``update_stats`` keyword that only its SN layers
take. The port builds what that code describes (plain convs with bias), and
the tests hold it to the JAX generator built with a flax ``Conv`` that
accepts and ignores the keyword (``conv_shim``); nothing in the JAX package
changes.

Tolerances: module forwards 1e-4 in f32 (the bound of the whole-D test,
``tests/test_torch_discriminator.py``), single layers and losses 1e-5. The
train-step options are in ``tests/test_torch_options_step.py``.
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ieagan_tpu import losses as jl
from ieagan_tpu.models import Discriminator as JaxD
from ieagan_tpu.models import Generator as JaxG
from ieagan_tpu.ops import attention as jattn
from ieagan_tpu.ops import diff_aug as jda
from ieagan_tpu.ops import norm as jnorm
from ieagan_tpu.ops import prior as jprior
from ieagan_tpu.ops import spectral as jsn
from ieagan_tpu.train import init_train_state as jax_init
from ieagan_torch import losses as tl
from ieagan_torch.kernels import flash_attention as fa
from ieagan_torch.models.convert import (discriminator_state_from_flax,
                                         generator_state_from_flax)
from ieagan_torch.models.discriminator import Discriminator
from ieagan_torch.models.generator import Generator
from ieagan_torch.ops import attention as tattn
from ieagan_torch.ops import diff_aug as tda
from ieagan_torch.ops import norm as tnorm
from ieagan_torch.ops import prior as tprior
from ieagan_torch.ops import spectral as tsn
from tests.helpers import tiny_config
from tests.test_torch_discriminator import (_carry_d, _check_spectral, _randomize_params,
                                            _spectral)
from tests.test_torch_generator import _randomize, pallas_interpreter  # noqa: F401
from tests.test_torch_primitives import carry, nchw_to_nhwc, nhwc_to_nchw
from tests.test_torch_train_step import _load, _variables

TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
SN_EPS = 1e-6


class _Conv(nn.Conv):
    """flax's Conv, taking and ignoring the ``update_stats`` keyword that the
    JAX generator passes every conv."""

    def __call__(self, inputs, update_stats=False):
        del update_stats
        return super().__call__(inputs)


@pytest.fixture
def conv_shim(monkeypatch):
    monkeypatch.setattr(nn, "Conv", _Conv)


@pytest.fixture
def prior_table(monkeypatch):
    """One seeded prior table in both packages (module state in each)."""
    table = np.random.default_rng(11).uniform(0.5, 2.0, 4).astype(np.float32)
    monkeypatch.setattr(jprior, "_FEATURES", table)
    monkeypatch.setattr(tprior, "_FEATURES", table)
    return table


# ---------------------------------------------------------------- layers

@pytest.mark.parametrize("style", ["in", "grp_4", "ch_2", "gn", "nonorm"])
def test_ccbn_norm_styles(style):
    """ccbn under each norm style but bn: group counts parsed as JAX parses
    them, gain and bias from the conditioning, and no running stats in
    either package."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 6, 5, 32)).astype(np.float32)
    y = rng.standard_normal((3, 12)).astype(np.float32)
    jmod = jnorm.ClassCondBatchNorm(32, functools.partial(jsn.SNDense, use_bias=False,
                                                          eps=SN_EPS), norm_style=style)
    v = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(y))
    assert "batch_stats" not in v
    want = jmod.apply(v, jnp.asarray(x), jnp.asarray(y), train=True)
    tmod = carry(tnorm.ClassCondBatchNorm(32, 12, functools.partial(
        tsn.SNLinear, bias=False, eps=SN_EPS), norm_style=style), v)
    assert not [n for n, _ in tmod.named_buffers() if not n.endswith((".u", ".sv"))]
    got = tmod(nhwc_to_nchw(x), torch.tensor(y))
    np.testing.assert_allclose(nchw_to_nhwc(got), np.asarray(want), **TOL)


def test_unknown_norm_style_raises_in_both():
    with pytest.raises(NotImplementedError):
        tnorm.ClassCondBatchNorm(8, 4, tsn.Linear, norm_style="layer")
    jmod = jnorm.ClassCondBatchNorm(8, jsn.Dense, norm_style="layer")
    with pytest.raises(NotImplementedError):
        jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 2, 8)), jnp.zeros((1, 4)))


@pytest.mark.parametrize("train", [False, True])
def test_cbam(train):
    """CBAM with SN convs: the channel gate's fc1/fc2 run twice, so their u
    advances twice in train mode, in both packages."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 12, 32)).astype(np.float32)
    jmod = jattn.CBAMAttention(32, functools.partial(jsn.SNConv, eps=SN_EPS))
    v = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    v = {"params": _randomize_params(v["params"], rng),
         "spectral": _spectral(v, rng)["spectral"]}
    want, ups = jmod.apply(v, jnp.asarray(x), update_stats=train, mutable=["spectral"])
    conv = lambda i, o, k: tsn.SNConv2d(i, o, k, eps=SN_EPS)
    tmod = carry(tattn.CBAMAttention(32, conv), v).train(train)
    got = tmod(nhwc_to_nchw(x))
    np.testing.assert_allclose(nchw_to_nhwc(got), np.asarray(want), **TOL)
    _check_spectral(tmod, (ups if train else v)["spectral"])


def test_ila():
    """ILA: plain 1x1 convs with bias, 8 heads of 32/64, both softmaxes in f32."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 10, 16)).astype(np.float32)
    jmod = jattn.ILA(16)
    v = jmod.init(jax.random.PRNGKey(2), jnp.asarray(x))
    v = {"params": _randomize_params(v["params"], rng)}
    want = jmod.apply(v, jnp.asarray(x))
    tmod = carry(tattn.ILA(16), v)
    np.testing.assert_allclose(nchw_to_nhwc(tmod(nhwc_to_nchw(x))), np.asarray(want), **TOL)


def test_prior_features(prior_table, tmp_path, monkeypatch):
    """The gathered, batch-normalized prior feature; the csv reader (column 8
    after a header row, read with the csv module); the uniform table when
    nothing is set."""
    y = np.array([3, 0, 2, 2, 1])
    want = np.asarray(jprior.prior_features(jnp.asarray(y), 4))
    got = tprior.prior_features(torch.tensor(y), 4)
    assert got.shape == (5, 1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    path = tmp_path / "features.csv"
    rows = ["," .join(f"c{i}" for i in range(10))] + [
        ",".join(str(i * 10 + j) for j in range(10)) for i in range(4)]
    path.write_text("\n".join(rows) + "\n")
    np.testing.assert_array_equal(tprior.load_prior_features(str(path)), [8, 18, 28, 38])
    monkeypatch.setattr(tprior, "_FEATURES", None)
    monkeypatch.setenv("IEAGAN_PRIOR_FEATURES", str(path))
    np.testing.assert_allclose(tprior.prior_features(torch.tensor([1]), 4, norm=False), [[18.0]])
    monkeypatch.setattr(tprior, "_FEATURES", None)
    monkeypatch.delenv("IEAGAN_PRIOR_FEATURES")
    np.testing.assert_array_equal(tprior.prior_features(torch.tensor([1, 3]), 4, norm=False),
                                  [[1.0], [1.0]])


def _cr_draws(key, shape):
    """``cr_diff_augment(key, x)``'s draws, replayed from its key chain."""
    b, h, w, _ = shape
    key, sub = jax.random.split(key)
    flip = np.asarray(jax.random.uniform(sub, (b, 1, 1, 1)) < 0.5).reshape(b)
    _, sub = jax.random.split(key)
    kh, kw = jax.random.split(sub)
    mh, mw = int(h / 8), int(w / 8)
    return {"flip": flip,
            "t_h": np.asarray(jax.random.randint(kh, (b, 1), -mh, mh + 1)).reshape(b),
            "t_w": np.asarray(jax.random.randint(kw, (b, 1), -mw, mw + 1)).reshape(b)}


def test_cr_diff_augment_matches_jax():
    """The flip and the reflect-padded translation, with the draws replayed
    from the JAX chain's own key splits; int(H / 8) truncates."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((12, 20, 44, 1)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jda.cr_diff_augment(key, jnp.asarray(x)))
    draws = {k: torch.tensor(v) for k, v in _cr_draws(key, x.shape).items()}
    assert draws["flip"].any() and not draws["flip"].all()
    assert draws["t_h"].abs().max() <= 2 and draws["t_w"].abs().max() <= 5
    np.testing.assert_array_equal(tda.cr_diff_augment(torch.tensor(x), draws).numpy(), want)
    sampled = tda.sample_cr_draws(torch.Generator().manual_seed(0), 200, 20, 44)
    assert sampled["t_h"].abs().max() == 2 and sampled["t_w"].abs().max() == 5
    assert 60 < int(sampled["flip"].sum()) < 140


# ---------------------------------------------------------------- models

def _jax_g_forward(module, variables, z, y, rdof):
    def interceptor(next_fun, args, kwargs, context):
        if context.module.name == "linear_f" and context.method_name == "__call__":
            args = (args[0].at[:, -rdof.shape[1]:].set(jnp.asarray(rdof)),) + tuple(args[1:])
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(interceptor):
        return np.asarray(module.apply(variables, jnp.asarray(z), jnp.asarray(y), train=False,
                                       rngs={"rdof": jax.random.PRNGKey(7)}))


# Each case combines options, so that every option meets its JAX twin once.
G_CASES = {
    # SA after the middle stage's last block, through the Pallas interpreter
    "sa_fused": dict(G_attn="16", attn_type="sa", use_pallas_attention=True),
    # PEGAN: SA at the last stage, inside the tail before output_bn; no RRM
    "pegan": dict(G_attn="32", RRM_prx_G=False, rdof_dim=0),
    "cbam_prior_instance_norm": dict(G_attn="16", attn_type="cbam", prior_embed=True,
                                     norm_style="in"),
    "ila_last_stage_no_hier_nonorm": dict(G_attn="32", attn_type="ila", hier=False,
                                          norm_style="nonorm"),
    "plain_params_sa_group_norm": dict(G_param="plain", G_attn="16", attn_type="sa",
                                       norm_style="grp_4", hier=False, RRM_prx_G=False,
                                       rdof_dim=0),
    "plain_params_cbam_channel_groups": dict(G_param="plain", G_attn="16", attn_type="cbam",
                                             norm_style="ch_2"),
}


@pytest.mark.parametrize("case", list(G_CASES))
def test_generator_option_matches_jax(case, prior_table, conv_shim,  # noqa: F811
                                      pallas_interpreter):
    """The tiny generator under each option, eval mode, from JAX's variables
    (random biases and running stats) on the same z and rdof."""
    cfg = tiny_config(**{"rdof_dim": 4, "compute_dtype": "float32", **G_CASES[case]})
    module = JaxG.from_config(cfg)
    es = cfg["n_classes"]
    rng = np.random.default_rng(12)
    z = rng.standard_normal((2 * es, cfg["dim_z"])).astype(np.float32)
    rdof = rng.standard_normal((2 * es, cfg["rdof_dim"])).astype(np.float32)
    y = np.tile(np.arange(es, dtype=np.int32), 2)
    variables = module.init({"params": jax.random.PRNGKey(0), "rdof": jax.random.PRNGKey(1)},
                            jnp.asarray(z), jnp.asarray(y), train=False)
    variables = _randomize(dict(variables), rng)
    variables["params"] = _randomize_params(variables["params"], rng)
    pallas_interpreter.clear()
    want = _jax_g_forward(module, variables, z, y, rdof)
    port = carry(Generator.from_config(cfg), variables).eval()
    if cfg["use_pallas_attention"]:
        assert len(pallas_interpreter) == 1 + cfg["RRM_prx_G"]
    with torch.no_grad():
        got = port(torch.tensor(z), torch.tensor(y).long(), torch.tensor(rdof))
    assert got.shape == want.shape == (2 * es, 32, 32, 1)
    np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)


def test_generator_layout_of_the_options():
    """Where each option puts its modules: attention after a stage's last
    block (inside the tail at the last stage), the prior's linears, the
    conditioning width without hier, plain layers without SN."""
    G = Generator.from_config(tiny_config(G_attn="32", attn_type="sa", prior_embed=True,
                                          hier=False, G_param="plain"))
    assert G.layer_names[-2:] == ["blocks_2_0", "attn_2"]
    assert isinstance(G.attn_2.theta, tsn.Conv2d) and isinstance(G.linear, tsn.Linear)
    assert tuple(G.shared.weight.shape) == (4, 64) and tuple(G.linear1.weight.shape) == (128, 128)
    assert G.linear.weight.shape[1] == 128  # z alone
    assert G.blocks_0_0.bn1.gain.weight.shape[1] == 128 and G.blocks_0_0.bn1.gain.bias is None
    G = Generator.from_config(tiny_config(G_attn="16", attn_type="unknown"))
    assert not [n for n in G.layer_names if n.startswith("attn")]


D_CASES = {
    "cbam_prior_embed": dict(attn_type="cbam", prior_embed=True),
    "ila_nonlinear_embed": dict(attn_type="ila", nonlinear_embed=True),
    "proj": dict(conditional_strategy="Proj"),
    "rrm_prx_d": dict(RRM_prx_D=True),
    "full_batch_sequence": dict(rrm_full_batch_sequence=True, RRM_prx_D=True, prior_embed=True),
    "no_rrm_embed": dict(RRM_embed=False, nonlinear_embed=True),
}


@pytest.mark.parametrize("case", list(D_CASES))
def test_discriminator_option_matches_jax(case, prior_table,  # noqa: F811
                                          pallas_interpreter):
    """The tiny D under each option in train mode with fused attention on
    both sides (RR_Dproxy: 4 heads of 256 through the Pallas interpreter and
    the port's plain versions): outputs and every updated u and sv."""
    cfg = tiny_config(use_pallas_attention=True, compute_dtype="float32", **D_CASES[case])
    jmod = JaxD.from_config(cfg)
    rng = np.random.default_rng(5)
    b = cfg["n_classes"] * cfg["events_per_batch"]
    x = rng.uniform(-1, 1, (b, 32, 32, 1)).astype(np.float32)
    y = np.tile(np.arange(cfg["n_classes"], dtype=np.int32), cfg["events_per_batch"])
    v = jmod.init({"params": jax.random.PRNGKey(3)}, jnp.asarray(x), jnp.asarray(y), train=False)
    v = {"params": _randomize_params(v["params"], rng), "spectral": _spectral(v, rng)["spectral"]}
    pallas_interpreter.clear()
    want, ups = jmod.apply(v, jnp.asarray(x), jnp.asarray(y), train=True, mutable=["spectral"])
    tmod = _carry_d(Discriminator.from_config(cfg), v).train()
    got = tmod(torch.tensor(x), torch.tensor(y).long())
    if cfg["conditional_strategy"] == "Proj":
        got, want = [got], [want]
        assert tuple(got[0].shape) == (b, 1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **MODEL_TOL)
    _check_spectral(tmod, ups["spectral"])
    if cfg["RRM_prx_D"]:
        seq = b if cfg["rrm_full_batch_sequence"] else cfg["n_classes"]
        assert (b // seq, 4, seq, 256) in pallas_interpreter


def test_d_param_is_ignored_as_in_jax():
    """D_param changes nothing in either package: the same SN layers, the
    same outputs from the same weights."""
    rng = np.random.default_rng(6)
    x = rng.uniform(-1, 1, (8, 32, 32, 1)).astype(np.float32)
    y = np.tile(np.arange(4, dtype=np.int32), 2)
    outs = []
    for d_param in ("SN", "other"):
        cfg = tiny_config(D_param=d_param, compute_dtype="float32")
        jmod = JaxD.from_config(cfg)
        v = jmod.init({"params": jax.random.PRNGKey(3)}, jnp.asarray(x), jnp.asarray(y),
                      train=False)
        want = jmod.apply(v, jnp.asarray(x), jnp.asarray(y), train=False)
        tmod = _carry_d(Discriminator.from_config(cfg), v).eval()
        got = tmod(torch.tensor(x), torch.tensor(y).long())
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **MODEL_TOL)
        outs.append((tmod.state_dict(), [g.detach() for g in got]))
    (sd_sn, out_sn), (sd_other, out_other) = outs
    assert set(sd_sn) == set(sd_other)
    for a, b in zip(out_sn, out_other):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------- losses

def _emb(seed, shape=(8, 16)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_conditional_contrastive_loss_plus(temperature):
    e, p = _emb(7), _emb(8)
    y = np.tile(np.arange(4), 2)
    mask = jl.make_mask(jnp.asarray(y), 4)
    fn = lambda e_, p_: jl.conditional_contrastive_loss_plus(e_, p_, mask, jnp.asarray(y),
                                                             temperature, 0.0)
    want, (ge, gp) = jax.value_and_grad(fn, argnums=(0, 1))(jnp.asarray(e), jnp.asarray(p))
    te, tp = torch.tensor(e, requires_grad=True), torch.tensor(p, requires_grad=True)
    got = tl.conditional_contrastive_loss_plus(te, tp, tl.make_mask(torch.tensor(y), 4),
                                               torch.tensor(y), temperature, 0.0)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(ge), **TOL)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(gp), **TOL)


@pytest.mark.parametrize("args", [
    ("Contra", "continuous", 1.0, 0.2, 300, 3, 1000),
    ("Contra", "discrete", 1.0, 0.2, 600, 3, 1000),
    ("Contra", "constant", 0.7, 0.2, 600, 3, 1000),
    ("Proj", "continuous", 1.0, 0.2, 300, 3, 1000),
])
def test_set_temperature(args):
    want = jl.set_temperature(*args)
    assert tl.set_temperature(*args) == (want if want == "no" else pytest.approx(want))


@pytest.fixture(scope="module")
def tiny_models():
    """The tiny G (no RRM) and D with plain attention, JAX variables and the
    port's modules with the same weights, in eval mode."""
    cfg = tiny_config(RRM_prx_G=False, rdof_dim=0, compute_dtype="float32")
    jG, jD = JaxG.from_config(cfg), JaxD.from_config(cfg)
    state = jax_init(jG, jD, cfg, jax.random.PRNGKey(0))
    gv = {"params": state.params_G, **state.state_G}
    dv = {"params": state.params_D, **state.state_D}
    G = _load(Generator.from_config(cfg), _variables(state.params_G, state.state_G),
              generator_state_from_flax).eval()
    D = _load(Discriminator.from_config(cfg), _variables(state.params_D, state.state_D),
              discriminator_state_from_flax).eval()
    return cfg, (jG, gv), (jD, dv), G, D


@pytest.mark.parametrize("which", ["gradient_penalty", "gradient_penalty_dragan"])
def test_gradient_penalties(tiny_models, which):
    """WGAN-GP and DRAGAN through the tiny D, with JAX's alpha and noise
    draws handed to the port."""
    cfg, _, (jD, dv), _, D = tiny_models
    rng = np.random.default_rng(9)
    real = rng.uniform(-1, 1, (8, 32, 32, 1)).astype(np.float32)
    fake = rng.uniform(-1, 1, (8, 32, 32, 1)).astype(np.float32)
    y = np.tile(np.arange(4, dtype=np.int32), 2)
    key = jax.random.PRNGKey(4)
    d_apply = lambda v, x, yy: jD.apply(v, x, yy, train=False)
    t_apply = lambda x, yy: D(x, yy)
    if which == "gradient_penalty":
        want = jax.jit(functools.partial(jl.gradient_penalty, d_apply))(
            dv, jnp.asarray(real), jnp.asarray(fake), jnp.asarray(y), key)
        alpha = np.asarray(jax.random.uniform(key, (8, 1, 1, 1)))
        got = tl.gradient_penalty(t_apply, torch.tensor(real), torch.tensor(fake),
                                  torch.tensor(y).long(), torch.tensor(alpha))
    else:
        want = jax.jit(functools.partial(jl.gradient_penalty_dragan, d_apply))(
            dv, jnp.asarray(real), jnp.asarray(y), key)
        k_alpha, k_noise = jax.random.split(key)
        alpha = np.asarray(jax.random.uniform(k_alpha, (8, 1, 1, 1)))
        noise = np.asarray(jax.random.uniform(k_noise, real.shape))
        got = tl.gradient_penalty_dragan(t_apply, torch.tensor(real), torch.tensor(y).long(),
                                         torch.tensor(alpha), torch.tensor(noise))
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_latent_gradient_norm(tiny_models):
    cfg, (jG, gv), (jD, dv), G, D = tiny_models
    rng = np.random.default_rng(10)
    z = rng.standard_normal((8, cfg["dim_z"])).astype(np.float32)
    y = np.tile(np.arange(4, dtype=np.int32), 2)
    want_g, want_n = jax.jit(lambda zz, yy: jl.latent_gradient_norm(
        lambda zz, yy: jG.apply(gv, zz, yy, train=False),
        lambda x, yy: jD.apply(dv, x, yy, train=False), zz, yy))(jnp.asarray(z), jnp.asarray(y))
    got_g, got_n = tl.latent_gradient_norm(lambda zz, yy: G(zz, yy), lambda x, yy: D(x, yy),
                                           torch.tensor(z), torch.tensor(y).long())
    assert tuple(got_n.shape) == (8, 1)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_n.numpy(), np.asarray(want_n), rtol=1e-4, atol=1e-5)


def test_fused_attention_refuses_create_graph():
    """B2's output carries no gradient: a second-order gradient through
    FlashAttention raises, a first-order one passes."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.tensor(rng.standard_normal((2, 5, 8)), dtype=torch.float32,
                            requires_grad=True) for _ in range(3))
    o = fa.FlashAttention.apply(q, k, v, 0.5)
    (g,) = torch.autograd.grad(o.sum(), q, retain_graph=True)
    assert torch.isfinite(g).all()
    with pytest.raises(RuntimeError, match="not differentiable"):
        torch.autograd.grad(o.sum(), q, create_graph=True)
