"""The train step under the bfloat16 policy, the port against the JAX package.

The tiny config of ``tests/test_torch_train_step.py`` (RRM proxy, rdof,
DiffAugment on fakes and reals, fused attention: Pallas interpreted on the
JAX side, B1/B2's plain versions on the port's), both frameworks' modules in
bfloat16 (JAX: ``from_config(config, dtype=jnp.bfloat16)``; port:
``compute_dtype=torch.bfloat16``), the same weights and the same draws:
z and rdof in f32 (each framework casts them), the fakes' DiffAugment draws
as JAX draws them in bfloat16 from the step's own keys, the reals' in f32.

What bfloat16 does to this step sets the tolerances. Against the f32 step
from the same state and draws, the JAX package's bf16 step moves the six
metrics by up to 0.28 (G_loss, 5%) and G's gradients by their own size
(per-leaf median error ~1.05): at G_ch 4 the rounding of a bf16 step is as
large as its signal. JAX's bf16 gradients of D's first layers also lose up to
60% of their norm (``input_conv``, ``blocks_0_0``, ``attn_0``/``attn_1``):
XLA:CPU accumulates those wide reductions in bf16, where the port (as the
TPU's MXU) accumulates in f32 and rounds once. So the gradients are held to
the f32 step, not to each other:

  * metrics, port against JAX, both bf16: rtol 1e-2 (2.5 bf16 ulps of 2**-8),
    atol 1e-4; measured worst 3.4e-3 relative (unif_loss_d);
  * per-leaf gradient error against the f32 step (||g_bf16 - g_f32|| /
    ||g_f32||, leaves null in exact arithmetic left out), max and median per
    network: the port's at most 1.1x the JAX package's; measured ratios
    0.23-1.005;
  * per-module gradient norms, relative distance from the f32 step's: the
    port's at most the JAX package's + 0.05; measured worst excess 0.034
    (G.output_conv).

The f32 reference is the port's f32 step, which ``test_torch_train_step.py``
holds to the JAX package's f32 step within 1e-5.
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
from ieagan_torch.core.precision import get_policy
from ieagan_torch.kernels import flash_attention as fa
from ieagan_torch.models.convert import (discriminator_state_from_flax,
                                         generator_state_from_flax)
from ieagan_torch.models.discriminator import Discriminator
from ieagan_torch.models.generator import Generator
from ieagan_torch.ops.diff_aug import sample_diff_aug_draws
from ieagan_torch.train.optim import make_optimizers
from ieagan_torch.train.step import TrainState, _on, make_train_step
from tests.helpers import tiny_config
from tests.test_torch_discriminator import _randomize_params
from tests.test_torch_eval import few_torch_threads  # noqa: F401 (autouse)
from tests.test_torch_losses import jax_draws
from tests.test_torch_train_step import _load, _variables

CONFIG = tiny_config(RRM_prx_G=True, rdof_dim=4, diff_aug=True, use_pallas_attention=True)
POLICY = CONFIG["diff_aug_policy"]
METRICS = ("D_loss_real", "D_loss_fake", "unif_loss_d", "iea_loss", "unif_loss_g", "G_loss")
METRIC_RTOL, METRIC_ATOL = 1e-2, 1e-4
LEAF_RATIO = 1.1
MODULE_NORM_SLACK = 0.05


@pytest.fixture(scope="module")
def steps():
    """The JAX package's bf16 step and the port's bf16 and f32 steps from one
    state and one set of draws. Returns (JAX metrics, port bf16 metrics,
    port f32 metrics, dtypes of the fused attention's inputs in the port's
    bf16 step)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("IEAGAN_PALLAS_INTERPRET", "1")
    import ieagan_tpu.ops.pallas as pallas_ops
    mp.setattr(pallas_ops, "flash_attention_available", lambda: True)
    try:
        cfg = CONFIG
        es, epb = cfg["n_classes"], cfg["events_per_batch"]
        b = es * epb
        rng = np.random.default_rng(0)
        jG = JaxG.from_config(cfg, dtype=jnp.bfloat16)
        jD = JaxD.from_config(cfg, dtype=jnp.bfloat16)
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

        def schedule(fake_dtype):
            return [z[0], rdof[0], jax_draws(kaug_d, x.shape, POLICY, fake_dtype),
                    jax_draws(jax.random.fold_in(kaug_d, 7), x.shape, POLICY, jnp.float32),
                    z[1], rdof[1], jax_draws(kaug_g, x.shape, POLICY, fake_dtype)]

        rdof_iter = iter(rdof)

        def interceptor(next_fun, args, kwargs, context):
            if context.module.name == "linear_f" and context.method_name == "__call__":
                a0 = args[0]
                args = (a0.at[:, -4:].set(jnp.asarray(next(rdof_iter)).astype(a0.dtype)),
                        ) + tuple(args[1:])
            return next_fun(*args, **kwargs)

        step = jax_make_step(jG, jD, cfg, z_schedule=z, capture_grads=True)
        with nn.intercept_methods(interceptor):
            _, jmets = jax.jit(step)(state, jnp.asarray(x), jnp.asarray(y), key)
        assert next(rdof_iter, None) is None

        dtypes = []
        fwd = fa.FlashAttention.forward

        def recorded(ctx, q, *args):
            dtypes.append(q.dtype)
            return fwd(ctx, q, *args)

        mp.setattr(fa.FlashAttention, "forward", staticmethod(recorded))
        port = {}
        for name, fake_dtype in (("bfloat16", jnp.bfloat16), ("float32", jnp.float32)):
            if name == "float32":
                mp.setattr(fa.FlashAttention, "forward", staticmethod(fwd))
            cdt = get_policy(name).compute_dtype
            G = _load(Generator.from_config(cfg), _variables(state.params_G, state.state_G),
                      generator_state_from_flax)
            G_ema = _load(Generator.from_config(cfg),
                          _variables(state.params_G_ema, state.state_G_ema),
                          generator_state_from_flax).eval().requires_grad_(False)
            D = _load(Discriminator.from_config(cfg), _variables(state.params_D, state.state_D),
                      discriminator_state_from_flax)
            tstate = TrainState(G.train(), D.train(), G_ema, *make_optimizers(G, D, cfg),
                                compute_dtype=cdt)
            port[name] = make_train_step(G, D, cfg,
                                         draw_schedule=schedule(fake_dtype),
                                         capture_grads=True)(
                tstate, torch.tensor(x), torch.tensor(y).long())
    finally:
        mp.undo()
    return jmets, port["bfloat16"], port["float32"], dtypes


def _grads(jmets, port_bf16, port_f32, net):
    convert = generator_state_from_flax if net == "G" else discriminator_state_from_flax
    jax_g = convert({"params": jax.tree_util.tree_map(np.asarray, jmets[f"_grads_{net}"])})
    to_np = lambda m: {k: v.double().numpy() for k, v in m[f"_grads_{net}"].items()}
    return jax_g, to_np(port_bf16), to_np(port_f32)


def _leaf_errors(got, ref):
    """Per-leaf ||got - ref|| / ||ref||, leaves null in exact arithmetic
    (f32 norm < 1e-5: conv biases feeding batch norms) left out."""
    return {k: np.linalg.norm(np.asarray(got[k], np.float64) - r) / np.linalg.norm(r)
            for k, r in ref.items() if np.linalg.norm(r) >= 1e-5}


def test_metrics_match_jax_in_bf16(steps):
    jmets, port_bf16, port_f32, _ = steps
    for name in METRICS:
        np.testing.assert_allclose(port_bf16[name], float(jmets[name]), rtol=METRIC_RTOL,
                                   atol=METRIC_ATOL, err_msg=name)
    # the policy is really in effect: bf16 moves the metrics off the f32 step
    assert max(abs(port_bf16[k] - port_f32[k]) for k in METRICS) > 1e-3


@pytest.mark.parametrize("net", ["G", "D"])
def test_gradients_are_as_close_to_f32_as_jax(steps, net):
    jmets, port_bf16, port_f32, _ = steps
    jax_g, port_g, ref = _grads(jmets, port_bf16, port_f32, net)
    mine, theirs = _leaf_errors(port_g, ref), _leaf_errors(jax_g, ref)
    assert len(mine) > 20
    for stat in (max, np.median):
        got, want = stat(list(mine.values())), stat(list(theirs.values()))
        assert got <= LEAF_RATIO * want, (net, stat.__name__, got, want)


@pytest.mark.parametrize("net", ["G", "D"])
def test_module_gradient_norms_are_as_close_to_f32_as_jax(steps, net):
    jmets, port_bf16, port_f32, _ = steps

    def norms(grads):
        out = {}
        for k, v in grads.items():
            out[k.split(".")[0]] = out.get(k.split(".")[0], 0.0) + float(np.sum(v * v))
        return {k: v ** 0.5 for k, v in out.items()}

    jax_n, port_n, ref_n = (norms(g) for g in _grads(jmets, port_bf16, port_f32, net))
    for module, ref in ref_n.items():
        mine, theirs = abs(port_n[module] - ref) / ref, abs(jax_n[module] - ref) / ref
        assert mine <= theirs + MODULE_NORM_SLACK, (net, module, mine, theirs)


def test_attention_runs_fused_in_bf16(steps):
    """B1 (and through FlashAttention's backward, B2) take bf16 inputs at every
    site: RR_G in both G passes, D's three image-attention stages and RR_D in
    each of three D passes."""
    *_, dtypes = steps
    assert dtypes == [torch.bfloat16] * (2 + 3 * 4)


def test_bf16_diff_aug_draws_have_jax_granularity():
    """The port's own bf16 colour draws are multiples of 2**-7, as
    ``jax.random.uniform(..., jnp.bfloat16)``'s are, and JAX's bf16 draws reach
    the step unchanged."""
    gen = torch.Generator().manual_seed(0)
    draws = sample_diff_aug_draws(gen, 4096, 32, 32, POLICY, dtype=torch.bfloat16)
    jdraws = jax_draws(jax.random.PRNGKey(1), (4096, 32, 32, 1), POLICY, jnp.bfloat16)
    for name, offset in (("brightness", 0.5), ("saturation", 0.0), ("contrast", -0.5)):
        for values in (draws[name].double().numpy(), np.asarray(jdraws[name], np.float64)):
            u = (values + offset) / (2.0 if name == "saturation" else 1.0)
            np.testing.assert_array_equal(u * 128, np.round(u * 128), err_msg=name)
            assert u.min() >= 0 and u.max() < 1 and len(np.unique(u)) > 100, name
        carried = _on("cpu", jdraws[name])
        assert carried.dtype == torch.bfloat16
        np.testing.assert_array_equal(carried.double().numpy(),
                                      np.asarray(jdraws[name], np.float64))


def test_policy_names():
    assert get_policy("bfloat16").compute_dtype == torch.bfloat16
    assert get_policy("float32").compute_dtype == torch.float32
    assert get_policy("bfloat16").param_dtype == torch.float32
    with pytest.raises(ValueError):
        get_policy("float16")


def test_chip_smoke_bf16_bounds_score_a_step_pair():
    """``chip_smoke.py`` phase 8's scoring on made-up steps: a step against
    itself breaks nothing; D's gradients 20% larger break only the D norm
    bound; G's gradients of another direction (same norms) break only G's
    cosine bound; metrics 10% off break only the metric bound. The gaps
    against their values by hand, within 1e-6 (the gradients are f32)."""
    import chip_smoke

    gen = torch.Generator().manual_seed(0)
    shapes = {"G": {"a.weight": (6, 5), "a.bias": (6,), "b.weight": (7,)},
              "D": {"c.weight": (4, 3), "d.weight": (5,)}}
    step = {f"_grads_{net}": {k: torch.randn(s, generator=gen) for k, s in leaves.items()}
            for net, leaves in shapes.items()}
    step.update({k: 0.5 + i for i, k in enumerate(chip_smoke.DRIVER_METRICS)})

    def score(other):
        return chip_smoke.gap_breaks(chip_smoke.step_gap(torch, np, other, step))

    assert score(step) == []
    scaled = dict(step, _grads_D={k: 1.2 * v for k, v in step["_grads_D"].items()})
    gap = chip_smoke.step_gap(torch, np, scaled, step)
    assert abs(gap["D_norm_rel"] - 0.2) < 1e-6 and abs(gap["D_cos_median"] - 1) < 1e-6
    assert score(scaled) == ["D norms"]
    turned = {}
    for k, v in step["_grads_G"].items():
        w = torch.randn(v.shape, generator=gen)
        w = w - (w.flatten() @ v.flatten()) / (v.flatten() @ v.flatten()) * v  # orthogonal
        turned[k] = w * (v.norm() / w.norm())
    gap = chip_smoke.step_gap(torch, np, dict(step, _grads_G=turned), step)
    assert abs(gap["G_cos_median"]) < 1e-6 and gap["G_norm_rel"] < 1e-6
    assert score(dict(step, _grads_G=turned)) == ["G cosine"]
    off = dict(step, **{k: step[k] * 1.1 for k in chip_smoke.DRIVER_METRICS})
    assert abs(chip_smoke.step_gap(torch, np, off, step)["metric_rel"] - 0.1) < 1e-6
    assert score(off) == ["metrics"]
