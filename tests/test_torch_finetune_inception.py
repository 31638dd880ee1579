"""``python -m ieagan_torch.eval.finetune_inception`` (the twin of
``scripts/finetune_inception.py``) against the JAX script on the CPU.

* The images load as the script loads them, and the train/val split is the
  script's for a seed (``:83-92``).
* A batch's uint8 -> [0, 1] -> 299x299 resize is ``jax_resize_single_channel``'s
  (within ``tests/test_torch_eval.py``'s resize bound against JAX, 5e-3).
* Two Adam steps of the classifier from one init, carried JAX -> port, match
  the JAX composition of ``:103-145`` built here (``InceptionV3Features``,
  ``nn.Dense``, optax's Adam under its cosine decay, the mean softmax
  cross-entropy, the batch indices injected), at the trunk's smallest input
  (75x75), a batch of 3, the script's learning rate: loss and accuracy of each step within 1e-5
  relative; each step's gradient of every leaf (all four batch-norm fields
  among them) within 1e-3 relative (norm); after the two steps, every
  element within twice the learning rates' sum of the JAX value (Adam moves
  an element by at most about its learning rate a step), and per leaf the
  update of the elements whose gradient is above 1e-4 of the leaf's largest
  in both steps within 1e-2 relative (norm). Below that a gradient is at
  its rounding, and Adam turns it into a step of the learning rate either
  way.
* The port's written msgpack loads with flax's ``serialization.from_bytes``
  onto the JAX ``InceptionV3Features`` template, bit for bit, and through
  the port's ``load_inception_state`` into its ``FeatureExtractor``.
"""

import importlib.util
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization
from PIL import Image

from ieagan_tpu.eval import inception as jax_inc
from ieagan_tpu.eval.resize import jax_resize_single_channel
from ieagan_torch.eval import finetune_inception as ft
from ieagan_torch.eval.fid import FeatureExtractor, load_inception_state
from ieagan_torch.eval.inception import inception_state_from_flax, init_feature_weights
from ieagan_torch.train.optim import OptaxAdam
from tests.test_torch_eval import few_torch_threads  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_CLASSES, SIZE, LR, STEPS = 3, (75, 75), 1e-4, 2


def jax_script():
    """``scripts/finetune_inception.py`` as a module (it imports JAX only
    inside ``main``)."""
    spec = importlib.util.spec_from_file_location(
        "jax_finetune_inception", os.path.join(REPO, "scripts", "finetune_inception.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _png_tree(root, sensors=3, events=4, shape=(30, 44)):
    rng = np.random.default_rng(2)
    for s in range(sensors):
        (root / f"1.{s}.1").mkdir(parents=True)
        for e in range(events):
            img = rng.integers(0, 256, shape).astype(np.uint8)
            Image.fromarray(img).save(root / f"1.{s}.1" / f"{e:03d}.png")
    return root


@pytest.mark.parametrize("max_events", [None, 3])
def test_images_load_as_the_jax_script(tmp_path, max_events):
    tree = _png_tree(tmp_path / "data")
    got, want = ft.load_raw_images(str(tree), max_events), jax_script().load_raw_images(
        str(tree), max_events)
    assert got[2] == want[2] == 3
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n,frac,seed", [(120, 0.1, 0), (120, 0.1, 7), (37, 0.25, 3), (5, 0.1, 1)])
def test_split_is_the_jax_scripts(n, frac, seed):
    # finetune_inception.py:89-92
    perm = np.random.default_rng(seed).permutation(n)
    n_val = int(n * frac)
    train, val = ft.split(n, frac, seed)
    np.testing.assert_array_equal(train, perm[n_val:])
    np.testing.assert_array_equal(val, perm[:n_val])


def test_batch_resize_matches_jax():
    imgs = np.random.default_rng(4).integers(0, 256, (5, 250, 768)).astype(np.uint8)
    idx = np.array([4, 0, 2])
    x, y = ft.batch_from_idx(torch.from_numpy(imgs), torch.arange(5), torch.from_numpy(idx))
    want = np.asarray(jax_resize_single_channel(jnp.asarray(imgs)[idx].astype(jnp.float32)
                                                / 255.0))
    assert x.shape == (3, 3, 299, 299) and y.tolist() == [4, 0, 2]
    assert np.abs(x.numpy() - want.transpose(0, 3, 1, 2)).max() < 5e-3


def test_cosine_decay_is_optax():
    sched, want = ft.cosine_decay(3e-4, 7), optax.cosine_decay_schedule(3e-4, 7)
    for count in range(10):
        assert sched(count) == pytest.approx(float(want(jnp.int32(count))), rel=1e-6, abs=0)
    assert sched(7) == sched(9) == 0.0


class JaxClassifier(nn.Module):
    """``scripts/finetune_inception.py:103-107``."""

    @nn.compact
    def __call__(self, x):
        return nn.Dense(N_CLASSES, name="fc")(jax_inc.InceptionV3Features(name="features")(x))


def _jax_steps(params, imgs, labels, idxs):
    """The JAX script's step (``:121-145``) on the injected indices:
    (params after each step, [loss, acc] and gradients of each step)."""
    model, tx = JaxClassifier(), optax.adam(optax.cosine_decay_schedule(LR, STEPS))

    @jax.jit
    def step(params, opt_state, idx):
        x = jax_resize_single_channel(jnp.asarray(imgs)[idx].astype(jnp.float32) / 255.0,
                                      size=SIZE)
        y = jnp.asarray(labels)[idx]

        def loss_fn(p):
            logits = model.apply({"params": p}, x)
            loss = optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()
            return loss, jnp.mean(jnp.argmax(logits, -1) == y)
        (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, jnp.stack([loss, acc]), grads

    opt_state, out = tx.init(params), []
    for idx in idxs:
        params, opt_state, metrics, grads = step(params, opt_state, jnp.asarray(idx))
        out.append((np.asarray(metrics), grads))
    return params, out


def _port_leaves(tree) -> dict:
    """A JAX classifier tree (params or gradients) under the port's names."""
    tree = jax.tree_util.tree_map(np.asarray, tree)
    out = {f"features.{k}": v for k, v in inception_state_from_flax(tree["features"]).items()}
    out["fc.weight"], out["fc.bias"] = tree["fc"]["kernel"].T, tree["fc"]["bias"]
    return out


def test_two_adam_steps_match_the_jax_composition():
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (6, 20, 24)).astype(np.uint8)
    labels = np.array([0, 1, 2, 0, 1, 2], np.int32)
    idxs = [np.array([0, 4, 2]), np.array([5, 1, 1])]
    # one init: the trunk's fallback weights, a seeded head
    init = {"features": jax_inc.convert_torch_state_dict(init_feature_weights(0)),
            "fc": {"kernel": (rng.standard_normal((2048, N_CLASSES)) * 0.02).astype(np.float32),
                   "bias": np.zeros(N_CLASSES, np.float32)}}
    final, steps = _jax_steps(init, imgs, labels, idxs)

    model = ft.InceptionClassifier(N_CLASSES)
    model.load_state_dict({k: torch.tensor(v) for k, v in _port_leaves(init).items()},
                          strict=True)
    names = dict(model.named_parameters())
    assert set(names) == set(model.state_dict())  # every batch-norm field is trained
    assert sum(k.endswith(("running_mean", "running_var")) for k in names) == 2 * 94
    opt, sched = OptaxAdam(model.parameters(), **ft.ADAM), ft.cosine_decay(LR, STEPS)
    grads = []
    for idx, (want_metrics, _) in zip(idxs, steps):
        got = ft.train_step(model, opt, torch.from_numpy(imgs), torch.from_numpy(labels),
                            torch.from_numpy(idx), sched, size=SIZE)
        np.testing.assert_allclose(got.numpy(), want_metrics, rtol=1e-5, atol=0)
        grads.append({k: p.grad.numpy().copy() for k, p in names.items()})

    before, after = _port_leaves(init), _port_leaves(final)
    want_grads = [_port_leaves(g) for _, g in steps]
    moved = 0
    for k, p in names.items():
        for g, w in zip(grads, want_grads):
            assert np.linalg.norm(g[k] - w[k]) <= 1e-3 * np.linalg.norm(w[k]), k
        got = p.detach().numpy()
        assert np.abs(got - after[k]).max() <= 2 * (sched(0) + sched(1)), k
        live = np.ones(got.shape, bool)
        for w in want_grads:
            live &= np.abs(w[k]) > 1e-4 * np.abs(w[k]).max()
        d_got, d_want = (got - before[k])[live], (after[k] - before[k])[live]
        if live.any():
            assert np.linalg.norm(d_got - d_want) <= 1e-2 * np.linalg.norm(d_want), k
            moved += 1
    assert moved > 0.9 * len(names)


def test_main_writes_a_backbone_both_packages_load(tmp_path, monkeypatch, capsys):
    """Two steps of ``main`` on a PNG tree (12 images, 3 sensors; batch 2,
    validation on one whole batch of the 3 held out): the printed lines of
    the JAX script; the msgpack read by flax onto the JAX template and by
    the port's extractor, equal to the trained trunk."""
    monkeypatch.setenv("IEAGAN_PLATFORM", "cpu")
    tree = _png_tree(tmp_path / "data")
    out = tmp_path / "stats" / "inception_pxd.msgpack"
    trained = {}
    write = ft.write_features

    def kept(model, path):
        trained.update({k: v.detach().clone() for k, v in model.features.state_dict().items()})
        write(model, path)

    monkeypatch.setattr(ft, "write_features", kept)
    res = ft.main(["--dataroot", str(tree), "--out", str(out), "--steps", "2", "--batch", "2",
                   "--val-frac", "0.25", "--lr", "1e-3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("12 images, 3 sensors, ")
    assert lines[1].startswith("dataset resident on cpu in ")
    assert lines[2].startswith("step 0: loss ") and " acc " in lines[2]
    assert lines[-2].startswith("validation accuracy: ") and lines[-2].endswith(" over 2 images")
    assert lines[-1] == f"saved feature-extractor params to {out}"
    assert res["n_val"] == 2 and np.isfinite(res["loss_acc"]).all()

    x = jnp.zeros((1, 75, 75, 3), jnp.float32)
    template = jax.eval_shape(lambda: jax_inc.InceptionV3Features().init(
        jax.random.PRNGKey(0), x))["params"]
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), template)
    flax_tree = serialization.from_bytes(template, out.read_bytes())
    state = inception_state_from_flax(jax.tree_util.tree_map(np.asarray, flax_tree))
    assert set(state) == set(trained)
    for k, v in trained.items():
        np.testing.assert_array_equal(state[k], v.numpy(), err_msg=k)
    loaded = load_inception_state(str(out))
    extractor = FeatureExtractor(str(out), device="cpu")
    for k, v in extractor.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), trained[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(loaded[k], trained[k].numpy(), err_msg=k)
    first = init_feature_weights(0)
    assert any(not np.array_equal(first[k], trained[k].numpy()) for k in trained)
