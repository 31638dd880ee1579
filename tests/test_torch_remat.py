"""Activation recompute (``remat``, ``remat_G``, ``remat_D``) in the port's
generator and discriminator (``ieagan_torch/ops/remat.py``).

Recompute changes memory and time, never numbers:

  * the port against itself: one train-mode forward of G into D and one
    backward, under every mode and override, against the same pass without
    recompute: outputs, every gradient and every buffer afterwards (``u``,
    ``sv``, running and standing batch-norm statistics, the standing
    counter) bit for bit. The tiny config has three G stages, so ``"wide"``
    (the last two) is a strict subset; one architecture puts G's attention
    at the last stage, inside the tail segment;
  * the port against the JAX models under the same mode, with the same
    weights, in train mode with the mutated collections returned: outputs,
    the gradients of a mean-weighted loss, and the updated ``u`` and batch
    statistics within 1e-5 (rtol and atol, element by element);
  * the control: after a pass ``u`` is one power iteration from where it
    started, not two, as a recompute that wrote state would leave it;
  * the recompute runs in the forward's ``contextvars`` context even when
    the backward runs in another thread (as CUDA's backward does), which
    is how a recompute keeps the step's global batch-norm moments.

Two ranks with recompute against one process are in
``tests/test_torch_parallel.py`` (case ``remat``).
"""

import contextvars
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from ieagan_tpu.models import Discriminator as JaxD
from ieagan_tpu.models import Generator as JaxG
from ieagan_torch.models.convert import (discriminator_state_from_flax,
                                         generator_state_from_flax)
from ieagan_torch.models.discriminator import Discriminator
from ieagan_torch.models import generator
from ieagan_torch.models.generator import Generator
from ieagan_torch.ops import remat
from ieagan_torch.ops.spectral import power_iteration
from tests.helpers import tiny_config
from tests.test_torch_discriminator import _randomize_params
from tests.test_torch_eval import few_torch_threads  # noqa: F401 (autouse)
from tests.test_torch_generator import _randomize

CONFIG = tiny_config(RRM_prx_G=True, rdof_dim=4, compute_dtype="float32")
# the architectures: the tiny flagship, and G's image attention at the last
# stage (resolution 32), which the tail segment then holds
ARCHS = {"flagship": {}, "G attention at the last stage": {"G_attn": "32"}}
# (architecture, remat keys, accumulate_standing)
CASES = [
    ("flagship", dict(remat=True), False),
    ("flagship", dict(remat="wide"), False),
    ("flagship", dict(remat_D=True), False),
    ("flagship", dict(remat_G="wide", remat_D=True), False),
    ("flagship", dict(remat=True), True),
    ("G attention at the last stage", dict(remat=True), False),
    ("G attention at the last stage", dict(remat="wide"), False),
]
TOL = 1e-5


def _case_id(case):
    arch, keys, standing = case
    return f"{arch}-" + ",".join(f"{k}={v}" for k, v in keys.items()) + (
        "-standing" if standing else "")


@pytest.fixture(scope="module")
def start():
    """Random-init weights of each architecture and the inputs of a pass:
    two events of latents, rdof, labels, and fixed weights of the outputs
    in the loss."""
    g = torch.Generator().manual_seed(0)
    weights = {}
    for arch, keys in ARCHS.items():
        cfg = dict(CONFIG, **keys)
        G, D = Generator.from_config(cfg), Discriminator.from_config(cfg)
        G.reset_parameters(g)
        D.reset_parameters(g)
        with torch.no_grad():
            for m in (G, D):
                for name, p in m.named_parameters():
                    if name.endswith(("bias", "gamma")):
                        p.copy_(torch.randn(p.shape, generator=g) * 0.1 + 0.3)
        weights[arch] = (G.state_dict(), D.state_dict())
    b = 2 * CONFIG["n_classes"]
    inputs = dict(z=torch.randn((b, CONFIG["dim_z"]), generator=g),
                  y=torch.arange(CONFIG["n_classes"]).repeat(2),
                  rdof=torch.randn((b, 4), generator=g),
                  w_fake=torch.randn((b, 32, 32, 1), generator=g),
                  w_embed=torch.randn((b, CONFIG["hypersphere_dim"]), generator=g),
                  w_out=torch.randn((b,), generator=g))
    return weights, inputs


def _pass(cfg, weights, inputs, standing):
    """G into D in train mode, one backward: outputs, gradients, buffers."""
    G, D = Generator.from_config(cfg), Discriminator.from_config(cfg)
    G.load_state_dict(weights[0], strict=True)
    D.load_state_dict(weights[1], strict=True)
    G.train()
    D.train()
    fake = G(inputs["z"], inputs["y"], inputs["rdof"], standing)
    proxy, embed, out = D(fake, inputs["y"])
    loss = ((fake * inputs["w_fake"]).sum() + ((proxy + embed) * inputs["w_embed"]).sum()
            + (out * inputs["w_out"]).sum())
    loss.backward()
    return {"outputs": [t.detach() for t in (fake, proxy, embed, out)],
            "grads": {f"{net}.{k}": p.grad for net, m in (("G", G), ("D", D))
                      for k, p in m.named_parameters()},
            "buffers": {f"{net}.{k}": v.clone() for net, m in (("G", G), ("D", D))
                        for k, v in m.named_buffers()},
            "modes": (G.remat, D.remat)}


@pytest.fixture(scope="module")
def references(start):
    """The pass without recompute, per architecture and standing flag."""
    weights, inputs = start
    return {(arch, standing): _pass(dict(CONFIG, **ARCHS[arch]), weights[arch], inputs, standing)
            for arch in ARCHS for standing in (False, True)}


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_recompute_is_bit_equal_to_none(start, references, case):
    arch, keys, standing = case
    weights, inputs = start
    cfg = dict(CONFIG, **ARCHS[arch], **keys)
    got = _pass(cfg, weights[arch], inputs, standing)
    want = references[(arch, standing)]
    assert got["modes"] == (remat.remat_mode(cfg, "G"), remat.remat_mode(cfg, "D"))
    assert want["modes"] == (False, False)
    for g, w in zip(got["outputs"], want["outputs"]):
        assert torch.equal(g, w)
    assert got["grads"].keys() == want["grads"].keys()
    for k, w in want["grads"].items():
        assert (got["grads"][k] is None) == (w is None), k
        assert w is None or torch.equal(got["grads"][k], w), k
    assert sum(w is not None for w in want["grads"].values()) > 50
    assert got["buffers"].keys() == want["buffers"].keys()
    for k, w in want["buffers"].items():
        assert torch.equal(got["buffers"][k], w), k


def test_segments_are_the_jax_models():
    """Which layers are segments, as the JAX models remat them: G's blocks
    before the tail (all under True, the last two stages' under "wide"), the
    tail from the last block on; D's stem, then every other block under
    True, those of the first two stages under "wide"."""
    cfg = dict(CONFIG, G_attn="32")
    G = Generator.from_config(dict(cfg, remat=True))
    assert G.layer_names[G.tail_start:] == ["blocks_2_0", "attn_2"]
    assert G.remat_blocks == {"blocks_0_0", "blocks_1_0"}
    assert Generator.from_config(dict(cfg, remat="wide")).remat_blocks == {"blocks_1_0"}
    assert Generator.from_config(cfg).remat_blocks == set()
    assert Discriminator.from_config(dict(cfg, remat=True)).remat_blocks == {"blocks_1_0",
                                                                             "blocks_2_0"}
    assert Discriminator.from_config(dict(cfg, remat="wide")).remat_blocks == {"blocks_1_0"}


@pytest.mark.parametrize("keys", [
    {}, dict(remat=True), dict(remat="wide"), dict(remat_D=True), dict(remat_G="wide"),
    dict(remat=True, remat_G=False), dict(remat_G="wide", remat_D=True)])
def test_modes_resolve_as_the_jax_models(keys):
    cfg = dict(CONFIG, **keys)
    assert Generator.from_config(cfg).remat == JaxG.from_config(cfg).remat
    assert Discriminator.from_config(cfg).remat == JaxD.from_config(cfg).remat


def test_mode_strings():
    """The CLI gives ``--remat_G`` as a string: ``"wide"``, a boolean word,
    or a refusal."""
    assert remat.remat_mode({"remat_G": "wide"}, "G") == "wide"
    assert remat.remat_mode({"remat_G": "True", "remat": False}, "G") is True
    assert remat.remat_mode({"remat_D": "false", "remat": True}, "D") is False
    assert remat.remat_mode({"remat_D": None, "remat": "wide"}, "D") == "wide"
    with pytest.raises(ValueError, match="remat_G 'full'"):
        remat.remat_mode({"remat_G": "full"}, "G")


def test_u_advances_once_not_twice(start, monkeypatch):
    """The control: with every G block a segment, a layer's ``u`` after the
    pass is one power iteration from its ``u`` before it. A plain
    ``torch.utils.checkpoint`` in place of the segment (its recompute
    writes state) leaves it two iterations on, and its pass's gradients
    differ from the pass without recompute."""
    weights, inputs = start
    layer = "blocks_0_0.conv2"
    u0 = weights["flagship"][0][f"{layer}.u"]
    w = weights["flagship"][0][f"{layer}.weight"]
    once = power_iteration(w.reshape(w.shape[0], -1), u0, 1, CONFIG["SN_eps"])[1]
    twice = power_iteration(w.reshape(w.shape[0], -1), once, 1, CONFIG["SN_eps"])[1]
    assert not torch.equal(once, twice)
    got = _pass(dict(CONFIG, remat=True), weights["flagship"], inputs, False)
    assert torch.equal(got["buffers"][f"G.{layer}.u"], once)
    monkeypatch.setattr(generator, "segment", lambda fn, modules, *args: checkpoint(
        fn, *args, use_reentrant=False))
    naive = _pass(dict(CONFIG, remat=True), weights["flagship"], inputs, False)
    assert torch.equal(naive["buffers"][f"G.{layer}.u"], twice)
    grads = _pass(CONFIG, weights["flagship"], inputs, False)["grads"]
    assert not torch.equal(naive["grads"][f"G.{layer}.weight"], grads[f"G.{layer}.weight"])


def test_recompute_runs_in_the_forward_context_in_another_thread():
    """A backward in another thread, as CUDA runs it, recomputes the segment
    with the context variables its forward saw, and leaves the caller's
    context as it was."""
    var = contextvars.ContextVar("var", default="unset")
    seen = []

    def fn(x):
        seen.append(var.get())
        return torch.sin(x * x)

    x = torch.randn(5, requires_grad=True)
    token = var.set("forward")
    out = remat.segment(fn, [], x)
    var.reset(token)
    worker = threading.Thread(target=lambda: out.sum().backward())
    worker.start()
    worker.join()
    assert seen == ["forward", "forward"]
    assert var.get() == "unset"
    torch.testing.assert_close(x.grad, torch.cos(x * x) * 2 * x, rtol=0, atol=0)


# ---------------------------------------------------------------- against JAX


def _jax_init(module, *args):
    """The module's variables, initialized under ``jax.jit`` (remat changes
    no parameter: one init serves every mode)."""
    return jax.jit(lambda *a: module.init({"params": jax.random.PRNGKey(0),
                                           "rdof": jax.random.PRNGKey(1)}, *a,
                                          train=False))(*args)


@pytest.fixture(scope="module")
def jax_g():
    """G with its attention at the last stage (inside the tail), no RRM proxy
    (JAX draws rdof inside): config, inputs, the loss's weights, and the
    JAX variables with random biases and running stats."""
    cfg = dict(CONFIG, G_attn="32", RRM_prx_G=False, rdof_dim=0)
    rng = np.random.default_rng(5)
    b = 2 * cfg["n_classes"]
    z = rng.standard_normal((b, cfg["dim_z"])).astype(np.float32)
    y = np.tile(np.arange(cfg["n_classes"], dtype=np.int32), 2)
    w = rng.standard_normal((b, 32, 32, 1)).astype(np.float32)
    variables = _jax_init(JaxG.from_config(cfg, dtype=jnp.float32), z, y)
    return cfg, z, y, w, _randomize(dict(variables), np.random.default_rng(2))


@pytest.fixture(scope="module")
def jax_d():
    cfg = dict(CONFIG)
    rng = np.random.default_rng(6)
    b = 2 * cfg["n_classes"]
    x = rng.uniform(-1, 1, (b, 32, 32, 1)).astype(np.float32)
    y = np.tile(np.arange(cfg["n_classes"], dtype=np.int32), 2)
    w = [rng.standard_normal(s).astype(np.float32)
         for s in ((b, cfg["hypersphere_dim"]), (b, cfg["hypersphere_dim"]), (b,))]
    variables = _jax_init(JaxD.from_config(cfg), x, y)
    variables = {"params": _randomize_params(variables["params"], np.random.default_rng(4)),
                 "spectral": variables["spectral"]}
    return cfg, x, y, w, variables


def _jax_g(cfg, variables, z, y, w):
    """The JAX generator in train mode: the output, the gradient of
    ``mean(out * w)`` and the updated collections."""
    module = JaxG.from_config(cfg, dtype=jnp.float32)

    def loss(params):
        out, upd = module.apply({**variables, "params": params}, jnp.asarray(z),
                                jnp.asarray(y), train=True, mutable=["spectral", "batch_stats"])
        return jnp.mean(out * jnp.asarray(w)), (out, upd)

    (_, (out, upd)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    return out, grads, upd


def _jax_d(cfg, variables, x, y, w):
    module = JaxD.from_config(cfg)

    def loss(params):
        outs, upd = module.apply({**variables, "params": params}, jnp.asarray(x),
                                 jnp.asarray(y), train=True, mutable=["spectral"])
        return sum(jnp.mean(o * jnp.asarray(wo)) for o, wo in zip(outs, w)), (outs, upd)

    (_, (outs, upd)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    return outs, grads, upd


def _to_port(module, variables, convert):
    tree = jax.tree_util.tree_map(np.asarray, {
        "params": variables["params"],
        "state": {k: v for k, v in variables.items() if k != "params"}})
    module.load_state_dict({k: torch.tensor(v) for k, v in
                            convert(tree, module.state_dict()).items()}, strict=True)
    return module


def _check_grads(module, grads, convert):
    want = convert({"params": jax.tree_util.tree_map(np.asarray, grads)})
    assert set(want) == {k for k, _ in module.named_parameters()}
    for k, p in module.named_parameters():
        got = np.zeros_like(want[k]) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, want[k], rtol=TOL, atol=TOL, err_msg=k)
    assert sum(float(np.abs(w).max()) > 1e-4 for w in want.values()) > 20


def _check_state(module, updates, convert):
    tree = jax.tree_util.tree_map(np.asarray, {"params": {}, "state": dict(updates)})
    want = convert(tree)
    buffers = dict(module.named_buffers())
    assert set(want) == set(buffers)
    for k, w in want.items():
        np.testing.assert_allclose(buffers[k].numpy(), w, rtol=TOL, atol=TOL, err_msg=k)


@pytest.mark.parametrize("mode", [True, "wide"])
def test_generator_matches_jax_under_the_same_mode(jax_g, mode):
    cfg, z, y, w, variables = jax_g
    cfg = dict(cfg, remat=mode)
    out, grads, upd = _jax_g(cfg, variables, z, y, w)
    G = _to_port(Generator.from_config(cfg), variables, generator_state_from_flax).train()
    assert G.remat == mode and "attn_2" in G.layer_names[G.tail_start:]
    got = G(torch.tensor(z), torch.tensor(y).long())
    torch.mean(got * torch.tensor(w)).backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=TOL, atol=TOL)
    _check_grads(G, grads, generator_state_from_flax)
    _check_state(G, upd, generator_state_from_flax)


@pytest.mark.parametrize("mode", [True, "wide"])
def test_discriminator_matches_jax_under_the_same_mode(jax_d, mode):
    cfg, x, y, w, variables = jax_d
    cfg = dict(cfg, remat=mode)
    outs, grads, upd = _jax_d(cfg, variables, x, y, w)
    D = _to_port(Discriminator.from_config(cfg), variables,
                 discriminator_state_from_flax).train()
    assert D.remat == mode
    got = D(torch.tensor(x), torch.tensor(y).long())
    sum(torch.mean(o * torch.tensor(wo)) for o, wo in zip(got, w)).backward()
    for g, o in zip(got, outs):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(o), rtol=TOL, atol=TOL)
    _check_grads(D, grads, discriminator_state_from_flax)
    _check_state(D, upd, discriminator_state_from_flax)
