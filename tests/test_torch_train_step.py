"""One train step of the port against one train step of the JAX package.

The tiny test config (``tests/helpers.py``) with the flagship's RRM proxy,
rdof, DiffAugment on fakes and reals, ortho-reg, EMA, and the fused attention
on both sides: JAX through its Pallas kernels in interpret mode, the port
through B1/B2's plain versions on the CPU. Both start from the same weights
(the JAX package's init, with random biases and SA gammas so that every leaf
matters, carried over by the port's converters) and see the same random
numbers:

  * z through JAX's ``z_schedule`` seam and the port's ``draw_schedule``;
  * rdof, which the JAX generator draws itself, by rewriting the input of
    its ``linear_f`` with ``flax.linen.intercept_methods`` (D phase, then G
    phase), as ``tests/test_torch_golden.py`` does;
  * the DiffAugment draws, replayed from the step's own key splits
    (``ieagan_tpu/train/step.py:226``, ``:234``, ``:308``).

Tolerances: the gradients per leaf, ||port - jax|| / ||jax||, max < 1e-2 and
median < 1e-3, the bound the JAX package holds its step to against the
reference PyTorch model (``tests/test_model_parity.py:518-520``); the metrics
rtol 2e-3, atol 2e-5, the same test's bound on the losses.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ieagan_tpu.models import Discriminator as JaxD
from ieagan_tpu.models import Generator as JaxG
from ieagan_tpu.train import init_train_state as jax_init
from ieagan_tpu.train import make_train_step as jax_make_step
from ieagan_torch.kernels import flash_attention as fa
from ieagan_torch.models.convert import (discriminator_state_from_flax,
                                         generator_state_from_flax)
from ieagan_torch.models.discriminator import Discriminator
from ieagan_torch.models.generator import Generator
from ieagan_torch.train.optim import make_optimizers
from ieagan_torch.train.step import TrainState, make_train_step
from tests.helpers import tiny_config
from tests.test_torch_discriminator import _randomize_params
from tests.test_torch_eval import few_torch_threads  # noqa: F401 (autouse)
from tests.test_torch_losses import jax_draws

CONFIG = tiny_config(RRM_prx_G=True, rdof_dim=4, diff_aug=True, use_pallas_attention=True,
                     compute_dtype="float32")
POLICY = CONFIG["diff_aug_policy"]
METRICS = ("D_loss_real", "D_loss_fake", "unif_loss_d", "iea_loss", "unif_loss_g", "G_loss")


def _variables(params, state):
    return jax.tree_util.tree_map(np.asarray, {"params": params, "state": state})


def _load(module, variables, convert):
    sd = convert(variables, module.state_dict())
    module.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    return module


def _leaf_errors(got: dict, want: dict):
    """Per-leaf ||got - want|| / ||want||; leaves whose JAX gradient is null
    in exact arithmetic (norm < 1e-5, e.g. conv biases feeding batch norms)
    must be null on the port's side too."""
    assert set(got) == set(want)
    errs = {}
    for name, w in want.items():
        g = got[name].double().numpy()
        w = np.asarray(w, np.float64)
        if np.linalg.norm(w) < 1e-5:
            assert np.linalg.norm(g) < 1e-5, name
            continue
        errs[name] = np.linalg.norm(g - w) / np.linalg.norm(w)
    return errs


@pytest.fixture(scope="module")
def one_step():
    """Both frameworks' step from the same state and draws, the JAX package's
    Pallas kernels in interpret mode; returns the JAX (old state, new state,
    metrics) and the port's (old G_ema state dict, state, metrics,
    attention calls)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("IEAGAN_PALLAS_INTERPRET", "1")
    import ieagan_tpu.ops.pallas as pallas_ops
    mp.setattr(pallas_ops, "flash_attention_available", lambda: True)
    try:
        cfg = CONFIG
        es, epb = cfg["n_classes"], cfg["events_per_batch"]
        b = es * epb
        rng = np.random.default_rng(0)
        jG, jD = JaxG.from_config(cfg), JaxD.from_config(cfg)
        state = jax_init(jG, jD, cfg, jax.random.PRNGKey(0))
        params_G = _randomize_params(state.params_G, rng)
        params_D = _randomize_params(state.params_D, rng)
        state = state.replace(params_G=params_G, params_D=params_D,
                              params_G_ema=jax.tree_util.tree_map(jnp.copy, params_G))
        x = rng.uniform(-1, 1, (b, 32, 32, 1)).astype(np.float32)
        y = np.tile(np.arange(es, dtype=np.int32), epb)
        z = [rng.standard_normal((b, cfg["dim_z"])).astype(np.float32) for _ in range(2)]
        rdof = [rng.standard_normal((b, 4)).astype(np.float32) for _ in range(2)]

        key = jax.random.PRNGKey(9)
        key1, _, _, kaug_d = jax.random.split(key, 4)
        _, _, _, kaug_g = jax.random.split(key1, 4)
        schedule = [z[0], rdof[0], jax_draws(kaug_d, x.shape, POLICY),
                    jax_draws(jax.random.fold_in(kaug_d, 7), x.shape, POLICY),
                    z[1], rdof[1], jax_draws(kaug_g, x.shape, POLICY)]

        rdof_iter = iter(rdof)

        def interceptor(next_fun, args, kwargs, context):
            if context.module.name == "linear_f" and context.method_name == "__call__":
                args = (args[0].at[:, -4:].set(jnp.asarray(next(rdof_iter))),) + tuple(args[1:])
            return next_fun(*args, **kwargs)

        step = jax_make_step(jG, jD, cfg, z_schedule=z, capture_grads=True)
        with nn.intercept_methods(interceptor):
            new_state, jmets = jax.jit(step)(state, jnp.asarray(x), jnp.asarray(y), key)
        assert next(rdof_iter, None) is None  # both G calls took their rdof

        G = _load(Generator.from_config(cfg),
                  _variables(state.params_G, state.state_G), generator_state_from_flax)
        G_ema = _load(Generator.from_config(cfg),
                      _variables(state.params_G_ema, state.state_G_ema),
                      generator_state_from_flax).eval().requires_grad_(False)
        D = _load(Discriminator.from_config(cfg),
                  _variables(state.params_D, state.state_D), discriminator_state_from_flax)
        ema0 = {k: v.clone() for k, v in G_ema.state_dict().items()}
        tstate = TrainState(G.train(), D.train(), G_ema, *make_optimizers(G, D, cfg))
        calls = {"fwd": 0, "bwd": 0}
        fwd, bwd = fa.FlashAttention.forward, fa.FlashAttention.backward

        def count(kind, fn):
            def counted(ctx, *args):
                calls[kind] += 1
                return fn(ctx, *args)
            return staticmethod(counted)

        mp.setattr(fa.FlashAttention, "forward", count("fwd", fwd))
        mp.setattr(fa.FlashAttention, "backward", count("bwd", bwd))
        tmets = make_train_step(G, D, cfg, draw_schedule=schedule, capture_grads=True)(
            tstate, torch.tensor(x), torch.tensor(y).long())
    finally:
        mp.undo()
    return (state, new_state, jmets), (ema0, tstate, tmets, calls)


def test_metrics_match_jax(one_step):
    (_, _, jmets), (_, tstate, tmets, _) = one_step
    for name in METRICS:
        np.testing.assert_allclose(tmets[name], float(jmets[name]), rtol=2e-3, atol=2e-5,
                                   err_msg=name)
    assert tstate.itr == 1


@pytest.mark.parametrize("net", ["D", "G"])
def test_gradients_match_jax_leaf_for_leaf(one_step, net):
    """The gradients each optimizer received (after ortho-reg: G_ortho 1e-4
    on G, D_ortho 0 on D), leaf for leaf."""
    (_, _, jmets), (_, _, tmets, _) = one_step
    convert = generator_state_from_flax if net == "G" else discriminator_state_from_flax
    want = convert({"params": jax.tree_util.tree_map(np.asarray, jmets[f"_grads_{net}"])})
    errs = _leaf_errors(tmets[f"_grads_{net}"], want)
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    assert len(errs) > 20
    assert max(errs.values()) < 1e-2, worst
    assert np.median(list(errs.values())) < 1e-3, worst


def test_attention_runs_fused_in_both_phases(one_step):
    """B1 and B2 through FlashAttention: B1 once per attention site per
    forward (G's RR_G twice, D's three SA stages and RR_D in each of three D
    passes), B2 wherever the loss needs the site's gradient (not RR_D of the
    D phase's fake pass, whose embedding no D loss reads)."""
    *_, calls = one_step[1]
    assert calls == {"fwd": 2 + 3 * 4, "bwd": 3 + 4 + 4 + 1}


def test_updated_weights_and_spectral_state_match_jax(one_step):
    """After Adam, every parameter of G and D; G's batch-norm stats; every u
    and sv (G's advanced twice, D's three times).

    Adam's first step moves a weight by lr * g / (|g| + eps). Where the
    gradient is real, the updates agree as the gradients do: per leaf
    ||port - jax|| / ||jax|| of the update < 1e-2. Where it is null in exact
    arithmetic (conv biases feeding batch norms), both frameworks' gradients
    are rounding noise of 1e-9..1e-6 that Adam scales up against eps = 1e-6,
    so those weights are only held to move by less than lr on both sides.
    u, sv and BN stats take no optimizer step: 1e-4 absolute."""
    (old_state, new_state, jmets), (_, tstate, _, _) = one_step
    lr = CONFIG["G_lr"]
    for net, module, convert in (("G", tstate.G, generator_state_from_flax),
                                 ("D", tstate.D, discriminator_state_from_flax)):
        params = lambda s: getattr(s, f"params_{net}")
        before = convert(_variables(params(old_state), getattr(old_state, f"state_{net}")))
        want = convert(_variables(params(new_state), getattr(new_state, f"state_{net}")))
        grads = convert({"params": jax.tree_util.tree_map(np.asarray, jmets[f"_grads_{net}"])})
        param_names = {n for n, _ in module.named_parameters()}
        for name, value in module.state_dict().items():
            got = value.numpy()
            if name not in param_names:
                np.testing.assert_allclose(got, want[name], rtol=0, atol=1e-4, err_msg=name)
                continue
            step_got, step_want = got - before[name], want[name] - before[name]
            if np.linalg.norm(grads[name]) < 1e-5:
                assert np.abs(step_got).max() < lr and np.abs(step_want).max() < lr, name
                continue
            err = np.linalg.norm(step_got - step_want) / np.linalg.norm(step_want)
            assert err < 1e-2, (name, err)


def test_ema_matches_jax(one_step):
    """With ema_start 1 the first step already uses decay 0.9999 over every
    float tensor of G's state: the port's G_ema is e * 0.9999 + p * 1e-4 of
    its own G exactly, and equals the JAX package's G_ema."""
    (_, new_state, _), (ema0, tstate, _, _) = one_step
    want = generator_state_from_flax(_variables(new_state.params_G_ema,
                                                new_state.state_G_ema))
    d = torch.tensor(0.9999, dtype=torch.float32)
    new_g = tstate.G.state_dict()
    for name, value in tstate.G_ema.state_dict().items():
        np.testing.assert_array_equal(
            value.numpy(), (ema0[name] * d + new_g[name] * (1 - d)).numpy(), err_msg=name)
        np.testing.assert_allclose(value.numpy(), want[name], rtol=0, atol=1e-6, err_msg=name)
    moved = [n for n, v in tstate.G_ema.state_dict().items() if not torch.equal(v, ema0[n])]
    assert moved, "EMA moved nothing"

