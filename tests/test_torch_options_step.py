"""One train step of the port against one of the JAX package under the step
options the flagship leaves off: Proj, consistency regularization (Contra and
Proj), concat mode with and without the full-batch RRM sequence, D's proxy
RRM (4 heads of 256) and the reference's G-step gating.

The set-up is ``tests/test_torch_train_step.py``'s: the JAX package's init
with random biases and SA gammas, carried over by the port's converters; the
same z (``z_schedule``), rdof (rewriting ``linear_f``'s input) and DiffAugment
and consistency draws (replayed from the step's key splits,
``ieagan_tpu/train/step.py:226``, ``:234``, ``:270``, ``:308``). The JAX
step takes its plain XLA attention here (its Pallas kernels inside a jitted
step are held to the port in ``tests/test_torch_train_step.py``, and compile
for minutes in interpret mode); the port's step takes ``FlashAttention``,
whose plain versions run on the CPU, so that the test sees the shapes the
kernels would be launched at.
Tolerances are that file's: metrics rtol 2e-3, atol 2e-5; per-leaf gradients
||port - jax|| / ||jax|| max < 1e-2, median < 1e-3; D's updated weights and
spectral state 1e-3 relative, 1e-4 absolute.
"""

from concurrent.futures import ThreadPoolExecutor

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
from tests.test_torch_options import _cr_draws
from tests.test_torch_train_step import _leaf_errors, _load, _variables

STEP_CASES = {
    # Proj, with Con_reg's score term
    "proj_con_reg": dict(conditional_strategy="Proj", Con_reg=True),
    # concat mode over the whole batch as one RRM sequence, RR_Dproxy,
    # Con_reg's score and embedding terms, and the reference's G-step gating
    "concat_full_batch": dict(split_D=False, rrm_full_batch_sequence=True, RRM_prx_D=True,
                              Con_reg=True, replicate_G_step_bug=True),
    # concat mode with per-event sequences
    "concat_per_event": dict(split_D=False, RRM_prx_D=True),
}


def _jax_case(name):
    """Case ``name``'s config, the JAX package's init with random biases and
    SA gammas, the batch and draws, and one JAX step from it: (cfg, state,
    x, y, the port's draw schedule, new state, metrics)."""
    cfg = tiny_config(RRM_prx_G=True, rdof_dim=4, diff_aug=True, use_pallas_attention=False,
                      compute_dtype="float32", **STEP_CASES[name])
    policy = cfg["diff_aug_policy"]
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
    schedule = [z[0], rdof[0], jax_draws(kaug_d, x.shape, policy),
                jax_draws(jax.random.fold_in(kaug_d, 7), x.shape, policy)]
    if cfg["Con_reg"]:
        schedule.append(_cr_draws(jax.random.fold_in(kaug_d, 1), x.shape))
    schedule += [z[1], rdof[1], jax_draws(kaug_g, x.shape, policy)]
    rdof_iter = iter(rdof)

    def interceptor(next_fun, args, kwargs, context):
        if context.module.name == "linear_f" and context.method_name == "__call__":
            args = (args[0].at[:, -4:].set(jnp.asarray(next(rdof_iter))),) + tuple(args[1:])
        return next_fun(*args, **kwargs)

    step = jax_make_step(jG, jD, cfg, z_schedule=z, capture_grads=True)
    with nn.intercept_methods(interceptor):
        new_state, jmets = jax.jit(step)(state, jnp.asarray(x), jnp.asarray(y), key)
    return cfg, state, x, y, schedule, new_state, jmets


@pytest.fixture(scope="module")
def jax_steps():
    """Every case's JAX side, each case in a thread of its own: their
    compiles overlap (XLA releases the GIL), and flax's method interceptors
    are per thread."""
    with ThreadPoolExecutor(len(STEP_CASES)) as pool:
        return dict(zip(STEP_CASES, pool.map(_jax_case, STEP_CASES)))


@pytest.fixture(scope="module", params=list(STEP_CASES))
def option_step(request, jax_steps):
    """One step of each package from the same state and draws: the JAX
    (old state, new state, metrics) and the port's (state, metrics, the
    shapes FlashAttention saw per phase)."""
    cfg, state, x, y, schedule, new_state, jmets = jax_steps[request.param]
    mp = pytest.MonkeyPatch()
    try:
        fused = dict(cfg, use_pallas_attention=True)
        G = _load(Generator.from_config(fused), _variables(state.params_G, state.state_G),
                  generator_state_from_flax)
        G_ema = _load(Generator.from_config(fused),
                      _variables(state.params_G_ema, state.state_G_ema),
                      generator_state_from_flax).eval().requires_grad_(False)
        D = _load(Discriminator.from_config(fused), _variables(state.params_D, state.state_D),
                  discriminator_state_from_flax)
        tstate = TrainState(G.train(), D.train(), G_ema, *make_optimizers(G, D, cfg))
        seen = []
        forward = fa.FlashAttention.forward
        mp.setattr(fa.FlashAttention, "forward", staticmethod(
            lambda ctx, q, *a: seen.append((D.linear0.weight.requires_grad, tuple(q.shape)))
            or forward(ctx, q, *a)))
        tmets = make_train_step(G, D, cfg, draw_schedule=schedule, capture_grads=True)(
            tstate, torch.tensor(x), torch.tensor(y).long())
    finally:
        mp.undo()
    return request.param, cfg, (state, new_state, jmets), (tstate, tmets, seen)


def test_option_step_metrics_and_gradients_match_jax(option_step):
    case, cfg, (_, _, jmets), (_, tmets, _) = option_step
    names = [k for k in jmets if not k.startswith("_")]
    assert set(names) == {k for k in tmets if not k.startswith("_")}
    if cfg["conditional_strategy"] == "Proj":
        assert set(names) == {"D_loss_real", "D_loss_fake", "G_loss"}
    for name in names:
        np.testing.assert_allclose(tmets[name], float(jmets[name]), rtol=2e-3, atol=2e-5,
                                   err_msg=f"{case}: {name}")
    for net, convert in (("D", discriminator_state_from_flax), ("G", generator_state_from_flax)):
        want = convert({"params": jax.tree_util.tree_map(np.asarray, jmets[f"_grads_{net}"])})
        errs = _leaf_errors(tmets[f"_grads_{net}"], want)
        worst = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
        assert max(errs.values()) < 1e-2, (case, net, worst)
        assert np.median(list(errs.values())) < 1e-3, (case, net, worst)


def test_option_step_updates_match_jax(option_step):
    """D's weights and spectral state after the step (its u advanced by every
    D pass: three, or four with Con_reg, under split_D; two, or three, in
    concat mode); G's weights unchanged under replicate_G_step_bug, moved
    otherwise, in both packages."""
    case, cfg, (old, new, _), (tstate, _, _) = option_step
    want_d = discriminator_state_from_flax(_variables(new.params_D, new.state_D))
    for name, value in tstate.D.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want_d[name], rtol=1e-3, atol=1e-4,
                                   err_msg=f"{case}: {name}")
    before_g = generator_state_from_flax(_variables(old.params_G, old.state_G))
    want_g = generator_state_from_flax(_variables(new.params_G, new.state_G))
    params = {n for n, _ in tstate.G.named_parameters()}
    stuck = cfg["replicate_G_step_bug"]
    for name, value in tstate.G.state_dict().items():
        if name in params:
            assert np.array_equal(value.numpy(), before_g[name]) == stuck, (case, name)
            assert np.array_equal(want_g[name], before_g[name]) == stuck, (case, name)


def test_option_step_attention_lengths(option_step):
    """In concat mode D's RRMs take 2 x es sequences in the D phase (one
    sequence of the whole [fake; real] batch with rrm_full_batch_sequence)
    and es-long ones in the G phase; RR_Dproxy runs at head width 256."""
    case, cfg, _, (_, _, seen) = option_step
    if not cfg["RRM_prx_D"]:
        return
    es, b = cfg["n_classes"], cfg["n_classes"] * cfg["events_per_batch"]
    d_phase = {shape for grad_d, shape in seen if grad_d}
    g_phase = {shape for grad_d, shape in seen if not grad_d}
    d_seq = 2 * b if cfg["rrm_full_batch_sequence"] else es
    assert (2 * b // d_seq * 4, d_seq, 256) in d_phase, (case, d_phase)
    g_seq = b if cfg["rrm_full_batch_sequence"] else es
    assert (b // g_seq * 4, g_seq, 256) in g_phase, (case, g_phase)
