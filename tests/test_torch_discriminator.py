"""The port's discriminator and its parts against the JAX package, with the
same weights, in train mode (spectral norm writes ``u`` and ``sv`` back) and
in eval mode.

JAX variables reach the port through the port's own carry-over, so these
tests also hold the layout mapping of every D leaf. The JAX discriminator
takes its Pallas attention kernel through the interpreter
(``IEAGAN_PALLAS_INTERPRET=1``, see ``tests/test_torch_generator.py``).
Inputs come from ``np.random.default_rng``. Tolerance 1e-5 for one layer and
1e-4 for the whole tiny discriminator: f32 on both sides, differing only in
summation order.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from ieagan_tpu.models import discriminator as jdisc
from ieagan_tpu.ops import attention as jattn
from ieagan_tpu.ops import rrm as jrrm
from ieagan_tpu.ops import spectral as jsn
from ieagan_torch.core.config import DEFAULT_CONFIG
from ieagan_torch.models import discriminator as tdisc
from ieagan_torch.models.convert import discriminator_state_from_flax
from ieagan_torch.ops import attention as tattn
from ieagan_torch.ops import spectral as tsn
from ieagan_torch.train.step import restore_train_state
from tests.helpers import tiny_config
from tests.test_torch_generator import pallas_interpreter  # noqa: F401 (fixture)
from tests.test_torch_primitives import carry, nchw_to_nhwc, nhwc_to_nchw

TOL = dict(rtol=1e-5, atol=1e-5)
CHECKPOINT = "artifacts/flagship_r4b"
SN_EPS = 1e-6


def _rng(seed):
    return np.random.default_rng(seed)


def _spectral(variables, rng):
    """Random ``u`` vectors, so the power iteration's result matters."""
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: (jnp.asarray(rng.standard_normal(leaf.shape), jnp.float32)
                            if path[-1].key == "u" else leaf), variables)


def _randomize_params(params, rng):
    """Random biases and a non-zero SA gamma, so every leaf matters."""
    def one(path, leaf):
        if path[-1].key in ("bias", "gamma"):
            return jnp.asarray(rng.standard_normal(leaf.shape) * 0.1 + 0.3 * (
                path[-1].key == "gamma"), jnp.float32)
        return leaf
    return jax.tree_util.tree_map_with_path(one, params)


def _check_spectral(module, spectral):
    """The port's ``u`` and ``sv`` equal the JAX package's updated ones."""
    flat = jax.tree_util.tree_flatten_with_path(spectral)[0]
    buffers = dict(module.named_buffers())
    assert len(flat) == len(buffers)
    for path, leaf in flat:
        name = ".".join(p.key for p in path)
        np.testing.assert_allclose(buffers[name].numpy(), np.asarray(leaf), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("train", [False, True])
def test_sn_embedding(train):
    """u has length num_embeddings; the (n, d) matrix is normalized; train
    mode writes u and sv back."""
    rng = _rng(1)
    y = np.array([3, 0, 5, 5, 1])
    jmod = jsn.SNEmbed(6, 9, eps=SN_EPS)
    v = _spectral(jmod.init(jax.random.PRNGKey(0), jnp.asarray(y)), rng)
    want, ups = jmod.apply(v, jnp.asarray(y), update_stats=train, mutable=["spectral"])
    tmod = carry(tsn.SNEmbedding(6, 9, eps=SN_EPS), v).train(train)
    assert tuple(tmod.u.shape) == (1, 6)
    got = tmod(torch.tensor(y))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    _check_spectral(tmod, (ups if train else v)["spectral"])


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_self_attention_2d(train, fused, pallas_interpreter):  # noqa: F811
    """SA over an NHWC map against NCHW in the port: theta/phi/g/o, the 2x2
    max pools, scale 1, gamma; fused takes the attention kernels' plain
    versions on the CPU and the Pallas kernel in JAX."""
    rng = _rng(2)
    x = rng.standard_normal((2, 8, 12, 32)).astype(np.float32)
    jmod = jattn.SelfAttention2d(32, functools.partial(jsn.SNConv, eps=SN_EPS),
                                 use_pallas=fused)
    v = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    v = {"params": _randomize_params(v["params"], rng),
         "spectral": _spectral(v, rng)["spectral"]}
    pallas_interpreter.clear()
    want, ups = jmod.apply(v, jnp.asarray(x), update_stats=train, mutable=["spectral"])
    assert len(pallas_interpreter) == int(fused)
    tmod = carry(tattn.SelfAttention2d(32, eps=SN_EPS, fused=fused), v).train(train)
    got = tmod(nhwc_to_nchw(x))
    np.testing.assert_allclose(nchw_to_nhwc(got), np.asarray(want), **TOL)
    _check_spectral(tmod, (ups if train else v)["spectral"])


@pytest.mark.parametrize("cin,cout,preact,down", [
    (8, 16, False, True),    # blocks_0_0: no preactivation, shortcut grown by conv_sc
    (16, 16, True, False),   # same width, no downsampling
    (16, 32, True, True),
])
def test_dblock(cin, cout, preact, down):
    rng = _rng(cin + cout)
    x = rng.standard_normal((2, 8, 12, cin)).astype(np.float32)
    jmod = jdisc.DBlock(cin, cout, functools.partial(jsn.SNConv, eps=SN_EPS),
                        jax.nn.relu, preactivation=preact, downsample=down)
    v = jmod.init(jax.random.PRNGKey(2), jnp.asarray(x))
    v = {"params": _randomize_params(v["params"], rng),
         "spectral": _spectral(v, rng)["spectral"]}
    want, ups = jmod.apply(v, jnp.asarray(x), update_stats=True, mutable=["spectral"])
    conv = lambda i, o, k: tsn.SNConv2d(i, o, k, eps=SN_EPS)
    tmod = carry(tdisc.DBlock(cin, cout, conv, torch.relu, preactivation=preact,
                              downsample=down), v).train()
    assert hasattr(tmod, "conv_sc") == (cin != cout)
    got = tmod(nhwc_to_nchw(x))
    np.testing.assert_allclose(nchw_to_nhwc(got), np.asarray(want), **TOL)
    _check_spectral(tmod, ups["spectral"])


def _carry_d(module, variables):
    tree = jax.tree_util.tree_map(np.asarray, {
        "params": variables["params"],
        "state": {k: v for k, v in variables.items() if k != "params"}})
    state = discriminator_state_from_flax(tree, module.state_dict())
    module.load_state_dict({k: torch.tensor(v) for k, v in state.items()}, strict=True)
    return module


@pytest.mark.parametrize("train", [False, True])
def test_tiny_discriminator_matches_jax_through_pallas(train, pallas_interpreter):  # noqa: F811
    """The tiny D (three SA stages, RR_D over 2 events of 4 sensors, the
    Contra head) with the fused attention on both sides: (proxy, embed,
    score) and, in train mode, every updated u and sv."""
    cfg = tiny_config(use_pallas_attention=True, compute_dtype="float32")
    jmod = jdisc.Discriminator.from_config(cfg)
    rng = _rng(5)
    b = cfg["n_classes"] * cfg["events_per_batch"]
    x = rng.uniform(-1, 1, (b, 32, 32, 1)).astype(np.float32)
    y = np.tile(np.arange(cfg["n_classes"], dtype=np.int32), cfg["events_per_batch"])
    v = jmod.init({"params": jax.random.PRNGKey(3)}, jnp.asarray(x), jnp.asarray(y), train=False)
    v = {"params": _randomize_params(v["params"], rng), "spectral": v["spectral"]}
    pallas_interpreter.clear()
    want, ups = jmod.apply(v, jnp.asarray(x), jnp.asarray(y), train=train, mutable=["spectral"])
    assert len(pallas_interpreter) == 4  # attn_0..attn_2 and RR_D
    tmod = _carry_d(tdisc.Discriminator.from_config(cfg), v).train(train)
    assert tmod.RR_D.layers_0.self_attn.fused and tmod.attn_0.fused
    got = tmod(torch.tensor(x), torch.tensor(y).long())
    for g, w, shape in zip(got, want, ((b, 1024), (b, 1024), (b,))):
        assert tuple(g.shape) == shape
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
    _check_spectral(tmod, (ups if train else v)["spectral"])


@pytest.fixture(scope="module")
def copy16000():
    with open(f"{CHECKPOINT}/D_copy16000.msgpack", "rb") as fp:
        tree = serialization.msgpack_restore(fp.read())
    state = restore_train_state(CHECKPOINT, "copy16000", device="cpu")
    return tree, state


def test_copy16000_carry_over_uses_every_key(copy16000):
    """The flagship D from the repo's checkpoint: every key carried, nothing
    left over, and the shapes of the flagship's attention sites."""
    tree, state = copy16000
    D = state.D
    converted = discriminator_state_from_flax(tree, D.state_dict())
    assert set(converted) == set(D.state_dict())
    for name, value in converted.items():
        np.testing.assert_array_equal(D.state_dict()[name].numpy(), value, err_msg=name)
    assert tuple(D.attn_2.theta.weight.shape) == (32, 256, 1, 1)
    assert tuple(D.attn_2.g.weight.shape) == (128, 256, 1, 1)
    assert tuple(D.RR_D.layers_0.self_attn.qkv_proj.weight.shape) == (1536, 512)
    assert state.itr == 16000 and D.RR_D.layers_0.self_attn.fused
    with pytest.raises(KeyError, match="missing"):
        bad = dict(tree, params={k: v for k, v in tree["params"].items() if k != "linear0"})
        discriminator_state_from_flax(bad, D.state_dict())


def test_copy16000_rr_d_and_attn_2_match_jax(copy16000, pallas_interpreter):  # noqa: F811
    """RR_D (4 heads of 128 over 40 sensors, SN linears) and the SA site
    attn_2 (32x96 positions, 256 channels) at flagship width with the
    copy16000 weights, in train mode, fused on both sides."""
    tree, state = copy16000
    D = state.D.train()
    rng = _rng(7)
    sn = functools.partial(jsn.SNDense, eps=SN_EPS)
    h = rng.standard_normal((2, 40, 512)).astype(np.float32)
    jrr = jrrm.RelationalReasoning(num_layers=1, input_dim=512, num_heads=4,
                                   dim_feedforward=512, which_linear=sn, use_pallas=True)
    rr_vars = {"params": tree["params"]["RR_D"], "spectral": tree["state"]["spectral"]["RR_D"]}
    want, ups = jrr.apply(rr_vars, jnp.asarray(h), update_stats=True, mutable=["spectral"])
    got = D.RR_D(torch.tensor(h))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    _check_spectral(D.RR_D, ups["spectral"])

    x = rng.standard_normal((1, 32, 96, 256)).astype(np.float32)
    jsa = jattn.SelfAttention2d(256, functools.partial(jsn.SNConv, eps=SN_EPS), use_pallas=True)
    sa_vars = {"params": tree["params"]["attn_2"],
               "spectral": tree["state"]["spectral"]["attn_2"]}
    want, ups = jsa.apply(sa_vars, jnp.asarray(x), update_stats=True, mutable=["spectral"])
    assert pallas_interpreter == [(2, 4, 40, 128), (1, 3072, 32)]
    got = D.attn_2(nhwc_to_nchw(x))
    np.testing.assert_allclose(nchw_to_nhwc(got), np.asarray(want), rtol=1e-4, atol=1e-4)
    _check_spectral(D.attn_2, ups["spectral"])
    assert DEFAULT_CONFIG["D_attn"] == "32" and DEFAULT_CONFIG["use_pallas_attention"]
