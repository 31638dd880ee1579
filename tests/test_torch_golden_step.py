"""The golden file of the JAX package's first flagship train step from
``copy16000`` (``ieagan_torch/train/golden_step_copy16000.json``), which
``chip_smoke.py`` holds the port's step on the card against.

The JAX side computes the step of ``ieagan_tpu/train/step.py`` on the CPU in
float32 at full width (one event of 40 images at 256x768) from the
checkpoint's G, D and G_ema with fresh Adam moments. Jitted whole, that step
needs more than 26 GiB of host memory on the CPU, so ``jax_step_by_phase``
evaluates the same package functions phase by phase, each phase its own
jitted program: G's forward; D's fake pass and real pass with their
gradients (the D loss is a sum of one term per pass, and D's ``u`` carries
no gradient); Adam; G's forward again and the gradient of the G loss with
respect to the image; G's backward. ``test_phase_by_phase_equals_the_jax_step``
holds that evaluation equal to ``make_train_step`` on the tiny config. The
attention takes the XLA composition (the Pallas kernel's reference) and
``remat`` is on; neither changes what is computed. z and rdof are given
(rdof by rewriting ``linear_f``'s input in an interceptor); the DiffAugment
draws come from the step's key splits, replayed and stored.

Write the file anew with ``python tests/test_torch_golden_step.py --write``
(about five minutes on 8 CPU cores, ~16 GiB of host memory).
"""

import json
import sys

import numpy as np
import pytest

from ieagan_torch.train import golden_step
from tests.helpers import tiny_config
from tests.test_torch_eval import few_torch_threads  # noqa: F401 (autouse)

CHECKPOINT = "artifacts/flagship_r4b"


def jax_step_by_phase(G, D, cfg, state, x, y, key, latents):
    """The metrics and the post-ortho gradient trees (``_grads_G``,
    ``_grads_D``) of ``ieagan_tpu.train.make_train_step(G, D, cfg)`` for one
    step from ``state`` (flagship options: split_D, one D step, no
    accumulation, Contra, DiffAugment on fakes and reals, IEA and uniformity
    on), with ``latents`` = [(z, rdof) of the D phase, of the G phase]."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    import optax

    from ieagan_tpu import losses
    from ieagan_tpu.ops.diff_aug import diff_augment
    from ieagan_tpu.train.ortho import apply_ortho_reg, shared_blacklist
    from ieagan_tpu.train.step import make_optimizers

    policy = cfg["diff_aug_policy"]
    mask = losses.make_mask(y, int(cfg["n_classes"]))
    contra = lambda e, p: float(cfg["contra_lambda"]) * losses.conditional_contrastive_loss(
        e, p, mask, y, float(cfg.get("temperature", 1.0)), 0.0,
        bool(cfg["pos_collected_numerator"]))
    unif_lambda = float(cfg["unif_lambda"])
    _, d_tx = make_optimizers(cfg)

    def with_rdof(fn, rdof):
        """``fn`` with linear_f's last rdof_dim input columns set to rdof."""
        def interceptor(next_fun, args, kwargs, context):
            if context.module.name == "linear_f" and context.method_name == "__call__":
                args = (args[0].at[:, -rdof.shape[1]:].set(rdof),) + tuple(args[1:])
            return next_fun(*args, **kwargs)

        def wrapped(*args):
            with nn.intercept_methods(interceptor):
                return fn(*args)
        return wrapped

    def g_apply(params, st, z, rdof, rkey):
        return with_rdof(lambda p: G.apply(
            {"params": p, **st}, z, y, train=True, rngs={"rdof": rkey},
            mutable=list(st.keys())), jnp.asarray(rdof))(params)

    def d_apply(params, st, img):
        return D.apply({"params": params, **st}, img, y, train=True, mutable=["spectral"])

    rng, _, krdof, kaug = jax.random.split(key, 4)
    (z, rdof), (z_g, rdof_g) = latents
    fake, state_G = jax.jit(lambda p, st: g_apply(p, st, z, rdof, krdof))(
        state.params_G, state.state_G)
    fake_in = diff_augment(kaug, jax.lax.stop_gradient(fake), policy)
    x_in = diff_augment(jax.random.fold_in(kaug, 7), x, policy)

    def fake_loss(p, st):
        (_, _, score_f), ups = d_apply(p, st, fake_in)
        return losses.loss_hinge_dis(score_f, jnp.full_like(score_f, 2.0))[1], ups

    def real_loss(p, st):
        (proxy_r, embed_r, score_r), ups = d_apply(p, st, x_in)
        loss_real = losses.loss_hinge_dis(jnp.full_like(score_r, -2.0), score_r)[0]
        u = losses.unif_loss(embed_r)
        return loss_real + contra(embed_r, proxy_r) + unif_lambda * u, (ups, loss_real, u, embed_r)

    (loss_fake, state_D), g_fake = jax.jit(jax.value_and_grad(fake_loss, has_aux=True))(
        state.params_D, state.state_D)
    (_, (state_D, loss_real, unif_d, embed_r)), g_real = jax.jit(
        jax.value_and_grad(real_loss, has_aux=True))(state.params_D, state_D)
    grads_D = apply_ortho_reg(jax.tree_util.tree_map(jnp.add, g_fake, g_real),
                              state.params_D, float(cfg["D_ortho"]))
    updates, _ = d_tx.update(grads_D, state.opt_D, state.params_D)
    params_D = optax.apply_updates(state.params_D, updates)

    _, _, krdof, kaug = jax.random.split(rng, 4)
    embed_r = jax.lax.stop_gradient(embed_r)

    def g_loss_of_image(img):
        (proxy_f, embed_f, score_f), ups = d_apply(params_D, state_D,
                                                   diff_augment(kaug, img, policy))
        il, ug = losses.iea_loss(embed_f, embed_r), losses.unif_loss(embed_f)
        g_loss = (losses.loss_hinge_gen(score_f) + contra(embed_f, proxy_f)
                  + float(cfg["IEA_lambda"]) * il + unif_lambda * ug)
        return g_loss, (il, ug)

    fake_g, _ = jax.jit(lambda p: g_apply(p, state_G, z_g, rdof_g, krdof))(state.params_G)
    (g_loss, (iea, unif_g)), d_img = jax.jit(jax.value_and_grad(g_loss_of_image, has_aux=True))(
        fake_g)
    grads_G = jax.jit(lambda p, ct: jax.vjp(
        lambda q: g_apply(q, state_G, z_g, rdof_g, krdof)[0], p)[1](ct)[0])(state.params_G, d_img)
    grads_G = apply_ortho_reg(grads_G, state.params_G, float(cfg["G_ortho"]),
                              blacklist=shared_blacklist)
    metrics = {"D_loss_real": loss_real, "D_loss_fake": loss_fake, "unif_loss_d": unif_d,
               "iea_loss": iea, "unif_loss_g": unif_g, "G_loss": g_loss}
    return {k: float(v) for k, v in metrics.items()}, grads_G, grads_D


def _flagship_state(cfg, G, D):
    """The JAX TrainState with copy16000's G, D and G_ema and fresh Adam."""
    import jax
    import jax.numpy as jnp
    from flax import serialization

    from ieagan_tpu.train import init_train_state

    state = init_train_state(G, D, cfg, jax.random.PRNGKey(0))
    tag = golden_step.CHECKPOINT_TAG

    def restore(base, params, st):
        with open(f"{CHECKPOINT}/{base}_{tag}.msgpack", "rb") as fp:
            tree = serialization.from_bytes({"params": params, "state": st}, fp.read())
        return tree["params"], tree["state"]

    params_G, state_G = restore("G", state.params_G, state.state_G)
    params_D, state_D = restore("D", state.params_D, state.state_D)
    params_E, state_E = restore("G_ema", state.params_G_ema, state.state_G_ema)
    with open(f"{CHECKPOINT}/state_dict_{tag}.json", encoding="utf-8") as fp:
        itr = json.load(fp)["itr"]
    return state.replace(params_G=params_G, state_G=state_G, params_D=params_D,
                         state_D=state_D, params_G_ema=params_E, state_G_ema=state_E,
                         itr=jnp.asarray(itr, jnp.int32)), itr


def build_golden(seed: int = 0) -> dict:
    import jax
    import jax.numpy as jnp

    from ieagan_tpu.core.config import DEFAULT_CONFIG
    from ieagan_tpu.models import Discriminator, Generator
    from ieagan_torch.models.convert import (discriminator_state_from_flax,
                                             generator_state_from_flax)
    from tests.test_torch_losses import jax_draws

    cfg = dict(DEFAULT_CONFIG, compute_dtype="float32", use_pallas_attention=False,
               remat=True)
    G, D = Generator.from_config(cfg), Discriminator.from_config(cfg)
    state, itr = _flagship_state(cfg, G, D)
    x, y, latents = golden_step.inputs(seed)
    key = jax.random.PRNGKey(seed)
    key1, _, _, kaug_d = jax.random.split(key, 4)
    _, _, _, kaug_g = jax.random.split(key1, 4)
    draws = [jax_draws(k, x.shape, cfg["diff_aug_policy"])
             for k in (kaug_d, jax.random.fold_in(kaug_d, 7), kaug_g)]
    metrics, grads_G, grads_D = jax_step_by_phase(G, D, cfg, state, jnp.asarray(x),
                                                  jnp.asarray(y), key, latents)
    grads = {
        "G": generator_state_from_flax({"params": jax.tree_util.tree_map(np.asarray, grads_G)}),
        "D": discriminator_state_from_flax(
            {"params": jax.tree_util.tree_map(np.asarray, grads_D)}),
    }
    entries = (golden_step.choose_entries(grads["G"], "G", seed + 1)
               + golden_step.choose_entries(grads["D"], "D", seed + 2))
    summary = golden_step.summarize(metrics, grads, entries)
    return {
        "seed": seed, "checkpoint": f"{CHECKPOINT} {golden_step.CHECKPOINT_TAG} "
                                    "(G, D, G_ema; fresh Adam)",
        "itr": itr,
        "draws": [{k: np.asarray(v).tolist() for k, v in d.items()} for d in draws],
        "metrics": summary["metrics"], "module_norms": summary["module_norms"],
        "entries": entries, "entries_values": summary["entries"],
    }


def test_phase_by_phase_equals_the_jax_step():
    """jax_step_by_phase gives make_train_step's metrics and gradients on the
    tiny config with the flagship's options (RRM proxy, rdof, DiffAugment
    on fakes and reals, G ortho-reg). The programs are split differently,
    so XLA fuses and sums in other orders: the metrics within 1e-5 (absolute
    on losses of order 1; G_loss is such a sum of terms that nearly cancel),
    per leaf ||by phase - step|| / ||step|| < 1e-4."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from ieagan_tpu.models import Discriminator, Generator
    from ieagan_tpu.train import init_train_state, make_train_step

    cfg = tiny_config(RRM_prx_G=True, rdof_dim=4, diff_aug=True, compute_dtype="float32")
    G, D = Generator.from_config(cfg), Discriminator.from_config(cfg)
    state = init_train_state(G, D, cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    b = cfg["n_classes"] * cfg["events_per_batch"]
    x = jnp.asarray(rng.uniform(-1, 1, (b, 32, 32, 1)).astype(np.float32))
    y = jnp.asarray(np.tile(np.arange(cfg["n_classes"], dtype=np.int32), 2))
    latents = [(rng.standard_normal((b, cfg["dim_z"])).astype(np.float32),
                rng.standard_normal((b, 4)).astype(np.float32)) for _ in range(2)]
    key = jax.random.PRNGKey(3)
    rdof_iter = iter([r for _, r in latents])

    def interceptor(next_fun, args, kwargs, context):
        if context.module.name == "linear_f" and context.method_name == "__call__":
            args = (args[0].at[:, -4:].set(jnp.asarray(next(rdof_iter))),) + tuple(args[1:])
        return next_fun(*args, **kwargs)

    step = make_train_step(G, D, cfg, z_schedule=[z for z, _ in latents], capture_grads=True)
    with nn.intercept_methods(interceptor):
        _, want = jax.jit(step)(state, x, y, key)
    metrics, grads_G, grads_D = jax_step_by_phase(G, D, cfg, state, x, y, key, latents)
    for k, v in metrics.items():
        np.testing.assert_allclose(v, float(want[k]), rtol=1e-5, atol=1e-5, err_msg=k)
    for got, ref in ((grads_G, want["_grads_G"]), (grads_D, want["_grads_D"])):
        for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                jax.tree_util.tree_leaves(ref)):
            g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
            if np.linalg.norm(w) < 1e-5:
                assert np.linalg.norm(g) < 1e-5, path
            else:
                assert np.linalg.norm(g - w) / np.linalg.norm(w) < 1e-4, path


def test_golden_step_file_is_well_formed():
    g = golden_step.load()
    assert g["seed"] == 0 and g["itr"] == 16000
    assert len(g["draws"]) == 3
    for d in g["draws"]:
        assert set(d) == {"brightness", "saturation", "contrast", "t_h", "t_w",
                          "off_h", "off_w"}
        assert all(len(v) == 40 for v in d.values())
        assert all(-0.5 <= b < 0.5 for b in d["brightness"])
        assert all(abs(t) <= 32 for t in d["t_h"]) and all(abs(t) <= 96 for t in d["t_w"])
    assert all(np.isfinite(g["metrics"][k]) for k in golden_step.METRICS)
    assert {"shared", "linear_f", "RR_G", "output_conv"} <= set(g["module_norms"]["G"])
    assert {"input_conv", "attn_2", "RR_D", "embed", "linear1"} <= set(g["module_norms"]["D"])
    assert 200 <= len(g["entries"]) == len(g["entries_values"]) <= 1000
    schedule = golden_step.draw_schedule(g)
    assert [np.shape(s) for s in schedule[:2]] == [(40, 128), (40, 4)]
    assert schedule[2]["t_h"].dtype.kind == "i"
    summary = {"metrics": g["metrics"], "module_norms": g["module_norms"],
               "entries": g["entries_values"]}
    result = golden_step.compare(g, summary)
    assert result["metrics_ok"] and result["module_norm_ok"] and result["entries_ok"]
    assert result["metrics_max_rel"] == result["module_norm_max_rel"] == 0.0


def test_compare_flags_each_kind_of_difference():
    g = golden_step.load()
    summary = {
        "metrics": {k: v * (1 + 2 * golden_step.METRIC_RTOL) + 1e-3
                    for k, v in g["metrics"].items()},
        "module_norms": {net: {k: v * (1 + 2 * golden_step.NORM_RTOL) for k, v in m.items()}
                         for net, m in g["module_norms"].items()},
        "entries": [v + 2 * golden_step.ENTRY_RMS_TOL * e[3]
                    for v, e in zip(g["entries_values"], g["entries"])],
    }
    result = golden_step.compare(g, summary)
    assert not (result["metrics_ok"] or result["module_norm_ok"] or result["entries_ok"])


@pytest.mark.slow
def test_golden_step_file_matches_jax():
    """Regenerate the golden step from the JAX package and check the file.
    The file holds its floats to 9 significant digits, so the chosen entries
    (with their leaf's RMS) and the draws are compared after that rounding."""
    g = golden_step.load()
    fresh = build_golden(g["seed"])
    assert _nine_digits(fresh["entries"]) == g["entries"]
    assert _nine_digits(fresh["draws"]) == g["draws"]
    summary = {"metrics": fresh["metrics"], "module_norms": fresh["module_norms"],
               "entries": fresh["entries_values"]}
    result = golden_step.compare(g, summary)
    assert result["metrics_max_rel"] <= 1e-5 and result["module_norm_max_rel"] <= 1e-5, result
    assert result["entry_max_err_over_rms"] <= 1e-4, result


def _nine_digits(obj):
    """Floats to 9 significant digits, which round-trip every float32."""
    if isinstance(obj, float):
        return float(f"{obj:.9g}")
    if isinstance(obj, list):
        return [_nine_digits(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _nine_digits(v) for k, v in obj.items()}
    return obj


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        raise SystemExit("usage: python tests/test_torch_golden_step.py --write")
    import jax
    jax.config.update("jax_platforms", "cpu")
    data = _nine_digits(build_golden(0))
    with open(golden_step.GOLDEN_PATH, "w", encoding="utf-8") as fp:
        json.dump(data, fp, separators=(",", ":"))
        fp.write("\n")
    print(f"wrote {golden_step.GOLDEN_PATH}")
