"""The port's primitives against their JAX twins, with the same weights.

Each JAX module is initialized by flax; its variables reach the port through
the port's own carry-over (``generator_state_from_flax``), so these tests also
hold the layout mapping of every leaf kind. Inputs come from
``np.random.default_rng``. Tolerances: f32 on both sides, differing only in
summation order and in how the batch-norm affine is grouped, so 1e-5 relative
to unit-scale outputs unless stated.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ieagan_tpu.ops import norm as jnorm
from ieagan_tpu.ops import rrm as jrrm
from ieagan_tpu.ops import spectral as jsn
from ieagan_torch.models.convert import generator_state_from_flax
from ieagan_torch.ops import norm as tnorm
from ieagan_torch.ops import rrm as trrm
from ieagan_torch.ops import spectral as tsn

TOL = dict(rtol=1e-5, atol=1e-5)


def carry(module, variables):
    """Load flax ``variables`` of a module into the port's twin ``module``
    through the port's carry-over, which must use every key."""
    tree = {"params": variables["params"],
            "state": {k: v for k, v in variables.items() if k != "params"}}
    tree = jax.tree_util.tree_map(np.asarray, tree)
    state = generator_state_from_flax(tree, module.state_dict())
    module.load_state_dict({k: torch.tensor(v) for k, v in state.items()}, strict=True)
    return module


def _rng(seed):
    return np.random.default_rng(seed)


def nhwc_to_nchw(x):
    return torch.tensor(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nchw_to_nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("num_svs,n_itrs", [(1, 1), (2, 1), (3, 2)])
def test_power_iteration(num_svs, n_itrs):
    """Singular values and updated u, Gram-Schmidt included (num_svs > 1)."""
    rng = _rng(num_svs * 10 + n_itrs)
    w = rng.standard_normal((24, 40)).astype(np.float32)
    u = rng.standard_normal((num_svs, 24)).astype(np.float32)
    sv_j, u_j = jsn.power_iteration(jnp.asarray(w), jnp.asarray(u), n_itrs, 1e-6)
    sv_t, u_t = tsn.power_iteration(torch.tensor(w), torch.tensor(u), n_itrs, 1e-6)
    np.testing.assert_allclose(sv_t.numpy(), np.asarray(sv_j), **TOL)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), **TOL)


def test_power_iteration_gradient_flows_through_w_only():
    rng = _rng(3)
    w = torch.tensor(rng.standard_normal((6, 9)).astype(np.float32), requires_grad=True)
    u = torch.tensor(rng.standard_normal((1, 6)).astype(np.float32))
    svs, new_u = tsn.power_iteration(w, u, 1, 1e-6)
    svs.sum().backward()
    assert w.grad is not None and not new_u.requires_grad
    grad_j = jax.grad(lambda w_: jsn.power_iteration(w_, jnp.asarray(u.numpy()), 1, 1e-6)[0].sum())(
        jnp.asarray(w.detach().numpy()))
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(grad_j), **TOL)


@pytest.mark.parametrize("train", [False, True])
def test_sn_linear(train):
    """Eval: the power iteration runs but u and sv stay as they were. Train:
    they are written back, equal to the JAX update."""
    rng = _rng(4)
    x = rng.standard_normal((5, 12)).astype(np.float32)
    jmod = jsn.SNDense(7, eps=1e-6)
    v = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = {**v, "spectral": {"u": jnp.asarray(rng.standard_normal((1, 7)), jnp.float32),
                           "sv": jnp.ones((1,), jnp.float32)}}
    want, ups = jmod.apply(v, jnp.asarray(x), update_stats=train, mutable=["spectral"])
    tmod = carry(tsn.SNLinear(12, 7, eps=1e-6), v).train(train)
    u_before = tmod.u.clone()
    got = tmod(torch.tensor(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    if train:
        np.testing.assert_allclose(tmod.u.numpy(), np.asarray(ups["spectral"]["u"]), **TOL)
        np.testing.assert_allclose(tmod.sv.numpy(), np.asarray(ups["spectral"]["sv"]), **TOL)
    else:
        assert torch.equal(tmod.u, u_before)
        assert torch.equal(tmod.sv, torch.ones(1))


@pytest.mark.parametrize("ksize", [1, 3])
def test_sn_conv(ksize):
    """NHWC/HWIO in JAX, NCHW/OIHW in the port; SAME padding; eval keeps u."""
    rng = _rng(ksize)
    x = rng.standard_normal((2, 6, 10, 8)).astype(np.float32)
    jmod = jsn.SNConv(5, kernel_size=(ksize, ksize), eps=1e-6)
    v = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    v = {"params": {**v["params"], "bias": jnp.asarray(rng.standard_normal(5), jnp.float32)},
         "spectral": v["spectral"]}
    want = jmod.apply(v, jnp.asarray(x))
    tmod = carry(tsn.SNConv2d(8, 5, ksize, eps=1e-6), v).eval()
    u_before = tmod.u.clone()
    got = tmod(nhwc_to_nchw(x))
    np.testing.assert_allclose(nchw_to_nhwc(got), np.asarray(want), **TOL)
    assert torch.equal(tmod.u, u_before)


def _stats(rng, c, counter):
    return {"mean": jnp.asarray(rng.standard_normal(c), jnp.float32),
            "var": jnp.asarray(rng.uniform(0.5, 2.0, c), jnp.float32),
            "accumulation_counter": jnp.asarray(counter, jnp.float32)}


@pytest.mark.parametrize("standing", [False, True])
def test_ccbn_eval(standing):
    """Eval ccbn with SN gain/bias linears: running stats, divided by the
    standing counter (4) when standing stats are in use."""
    rng = _rng(7)
    c, cond = 6, 10
    x = rng.standard_normal((3, 4, 5, c)).astype(np.float32)
    y = rng.standard_normal((3, cond)).astype(np.float32)
    linear = functools.partial(jsn.SNDense, use_bias=False, eps=1e-6)
    jmod = jnorm.ClassCondBatchNorm(c, linear)
    v = jmod.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(y), train=False)
    v = {**v, "batch_stats": _stats(rng, c, 4.0 if standing else 0.0)}
    want = jmod.apply(v, jnp.asarray(x), jnp.asarray(y), train=False,
                      accumulate_standing=standing)
    tmod = carry(tnorm.ClassCondBatchNorm(
        c, cond, functools.partial(tsn.SNLinear, bias=False, eps=1e-6)), v).eval()
    got = tmod(nhwc_to_nchw(x), torch.tensor(y), accumulate_standing=standing)
    np.testing.assert_allclose(nchw_to_nhwc(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("standing", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_bn(standing, train):
    """Plain BN: eval with running or standing stats; train with batch
    moments and the running (momentum 0.1, unbiased var) or standing update."""
    rng = _rng(8)
    c = 4
    x = rng.standard_normal((3, 5, 6, c)).astype(np.float32) * 2 + 1
    jmod = jnorm.BatchNorm(c)
    v = jmod.init(jax.random.PRNGKey(3), jnp.asarray(x), train=False)
    v = {"params": {"gain": jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32),
                    "bias": jnp.asarray(rng.standard_normal(c), jnp.float32)},
         "batch_stats": _stats(rng, c, 3.0 if standing else 0.0)}
    want, ups = jmod.apply(v, jnp.asarray(x), train=train,
                           accumulate_standing=standing, mutable=["batch_stats"])
    tmod = carry(tnorm.BatchNorm(c), v).train(train)
    got = tmod(nhwc_to_nchw(x), accumulate_standing=standing)
    np.testing.assert_allclose(nchw_to_nhwc(got), np.asarray(want), **TOL)
    for name in ("mean", "var", "accumulation_counter"):
        np.testing.assert_allclose(getattr(tmod, name).numpy(),
                                   np.asarray(ups["batch_stats"][name]), **TOL)


def test_layer_norm():
    rng = _rng(9)
    x = (rng.standard_normal((2, 40, 16)) * 3 + 2).astype(np.float32)
    jmod = jnorm.LayerNorm()
    v = jmod.init(jax.random.PRNGKey(4), jnp.asarray(x))
    v = {"params": {"scale": jnp.asarray(rng.uniform(0.5, 1.5, 16), jnp.float32),
                    "bias": jnp.asarray(rng.standard_normal(16), jnp.float32)}}
    want = jmod.apply(v, jnp.asarray(x))
    got = carry(tnorm.LayerNorm(16), v)(torch.tensor(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("fused", [False, True])
def test_relational_reasoning(fused):
    """G's RRM (plain linears, 2 heads of 64 over 40 sensors) with random
    biases so every leaf matters; the port's attention plain or fused (its
    kernel's plain version on the CPU)."""
    rng = _rng(10)
    x = rng.standard_normal((3, 40, 128)).astype(np.float32)
    jmod = jrrm.RelationalReasoning(num_layers=1, input_dim=128, num_heads=2,
                                    dim_feedforward=128, which_linear=jsn.Dense)
    v = jmod.init(jax.random.PRNGKey(5), jnp.asarray(x))
    v = {"params": jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape) * 0.1, jnp.float32),
        v["params"])}
    want = jmod.apply(v, jnp.asarray(x))
    tmod = carry(trrm.RelationalReasoning(1, 128, 2, 128, tsn.Linear, fused=fused), v)
    got = tmod(torch.tensor(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", ["lognorm255", "lognorm", "denorm", "generate_postprocess"])
def test_image_norms(name):
    """Data-domain transforms on the same inputs; 1e-5 relative (f32 log/pow)."""
    from ieagan_tpu.ops import image_norm as jnorms
    from ieagan_torch.ops import image_norm as tnorms
    rng = _rng(12)
    x = {"lognorm255": rng.uniform(0, 1, (3, 8)),
         "lognorm": rng.uniform(0, 255, (3, 8)),
         "denorm": rng.uniform(-1, 1, (2, 16, 5, 1)),
         "generate_postprocess": rng.uniform(-1, 1, (2, 16, 5, 1))}[name].astype(np.float32)
    want = np.asarray(getattr(jnorms, name)(jnp.asarray(x)))
    got = getattr(tnorms, name)(torch.tensor(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_config_copy_matches_jax(tmp_path):
    """The port's own config surface equals the JAX package's."""
    import json
    from ieagan_tpu.core import config as jconfig
    from ieagan_torch.core import config as tconfig
    assert tconfig.DEFAULT_CONFIG == jconfig.DEFAULT_CONFIG
    path = tmp_path / "config.json"
    path.write_text(json.dumps({"G_ch": 8, "n_classes": 12}))
    overrides = {"resolution": 64, "seed": None}
    assert (tconfig.load_config(str(path), overrides)
            == jconfig.load_config(str(path), overrides))
    assert tconfig.event_size(tconfig.load_config(str(path))) == 12
