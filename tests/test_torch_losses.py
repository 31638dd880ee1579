"""The port's losses and DiffAugment against the JAX package, and ortho-reg
and the optimizer against theirs, on the same inputs.

DiffAugment: the JAX package draws inside its chain from a key; the port
takes the draws as an input. ``jax_draws`` replays ``diff_augment``'s own
``jax.random.split`` chain on the same key to get the numbers the JAX chain
used, and hands them to the port. Inputs come from
``np.random.default_rng``. Tolerance 1e-5 unless stated: f32 on both sides,
differing only in summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ieagan_tpu import losses as jl
from ieagan_tpu.ops import diff_aug as jda
from ieagan_tpu.train.ortho import apply_ortho_reg as jax_ortho
from ieagan_tpu.train.ortho import shared_blacklist
from ieagan_torch import losses as tl
from ieagan_torch.ops import diff_aug as tda
from ieagan_torch.ops import spectral as tsn
from ieagan_torch.train.optim import make_optimizer
from ieagan_torch.train.ortho import apply_ortho_reg

TOL = dict(rtol=1e-5, atol=1e-5)


def jax_draws(key, x_shape, policy):
    """The draws ``ieagan_tpu.ops.diff_aug.diff_augment(key, x, policy)``
    takes, replayed from its key chain, in the port's format."""
    b, h, w, _ = x_shape
    draws = {}
    for p in policy.split(","):
        for name in {"color": ("brightness", "saturation", "contrast"),
                     "translation": ("translation",), "cutout": ("cutout",)}[p]:
            key, sub = jax.random.split(key)
            u = lambda: np.asarray(jax.random.uniform(sub, (b, 1, 1, 1), jnp.float32)).reshape(b)
            if name == "brightness":
                draws[name] = u() - np.float32(0.5)
            elif name == "saturation":
                draws[name] = u() * np.float32(2.0)
            elif name == "contrast":
                draws[name] = u() + np.float32(0.5)
            elif name == "translation":
                sh, sw = int(h * 0.125 + 0.5), int(w * 0.125 + 0.5)
                kh, kw = jax.random.split(sub)
                draws["t_h"] = np.asarray(jax.random.randint(kh, (b, 1), -sh, sh + 1)).reshape(b)
                draws["t_w"] = np.asarray(jax.random.randint(kw, (b, 1), -sw, sw + 1)).reshape(b)
            else:
                ch, cw = int(h * 0.5 + 0.5), int(w * 0.5 + 0.5)
                kh, kw = jax.random.split(sub)
                draws["off_h"] = np.asarray(jax.random.randint(
                    kh, (b, 1, 1), 0, h + (1 - ch % 2))).reshape(b)
                draws["off_w"] = np.asarray(jax.random.randint(
                    kw, (b, 1, 1), 0, w + (1 - cw % 2))).reshape(b)
    return draws


def _emb(seed, shape=(8, 16)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_hinge_losses():
    f, r = _emb(0, (12,)), _emb(1, (12,))
    for got, want in zip(tl.loss_hinge_dis(torch.tensor(f), torch.tensor(r)),
                         jl.loss_hinge_dis(jnp.asarray(f), jnp.asarray(r))):
        np.testing.assert_allclose(float(got), float(want), **TOL)
    np.testing.assert_allclose(float(tl.loss_hinge_gen(torch.tensor(f))),
                               float(jl.loss_hinge_gen(jnp.asarray(f))), **TOL)


@pytest.mark.parametrize("name", ["unif_loss", "iea_loss", "l2_loss"])
def test_embedding_losses_and_gradients(name):
    """Value and gradient with respect to the first argument (IEA's target
    is detached on both sides)."""
    a, b = _emb(2) / 4, _emb(3) / 4
    args = {"unif_loss": (a,), "iea_loss": (a, b), "l2_loss": (a, b)}[name]
    jfn, tfn = getattr(jl, name), getattr(tl, name)
    want, jgrad = jax.value_and_grad(lambda x0, *rest: jfn(x0, *rest))(
        *(jnp.asarray(t) for t in args))
    t_args = [torch.tensor(t, requires_grad=True) for t in args]
    got = tfn(*t_args)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(t_args[0].grad.numpy(), np.asarray(jgrad), **TOL)
    if name == "iea_loss":
        assert t_args[1].grad is None


def test_make_mask():
    y = np.array([0, 2, 1, 2, 3])
    np.testing.assert_array_equal(tl.make_mask(torch.tensor(y), 4).numpy(),
                                  np.asarray(jl.make_mask(jnp.asarray(y), 4)))


@pytest.mark.parametrize("pos_collected", [False, True])
@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_conditional_contrastive_loss(pos_collected, temperature):
    """2C with labels that repeat (two events), value and the gradients with
    respect to the embeddings and the proxies."""
    e, p = _emb(4), _emb(5)
    y = np.tile(np.arange(4), 2)
    mask = jl.make_mask(jnp.asarray(y), 4)
    fn = lambda e_, p_: jl.conditional_contrastive_loss(
        e_, p_, mask, jnp.asarray(y), temperature, 0.0, pos_collected)
    want, (ge, gp) = jax.value_and_grad(fn, argnums=(0, 1))(jnp.asarray(e), jnp.asarray(p))
    te, tp = torch.tensor(e, requires_grad=True), torch.tensor(p, requires_grad=True)
    got = tl.conditional_contrastive_loss(te, tp, tl.make_mask(torch.tensor(y), 4),
                                          torch.tensor(y), temperature, 0.0, pos_collected)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(ge), **TOL)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(gp), **TOL)


@pytest.mark.parametrize("policy", ["color,translation,cutout", "color", "translation",
                                    "cutout", "translation,cutout"])
@pytest.mark.parametrize("hw", [(32, 32), (24, 40)])
def test_diff_augment_matches_jax(policy, hw):
    """The chain on replayed draws equals the JAX chain on its key; the
    gradient with respect to the images too (zero where cut out or shifted
    out)."""
    h, w = hw
    x = np.random.default_rng(6).uniform(-1, 1, (6, h, w, 1)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    cot = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)
    want, vjp = jax.vjp(lambda t: jda.diff_augment(key, t, policy), jnp.asarray(x))
    draws = {k: torch.tensor(v) for k, v in jax_draws(key, x.shape, policy).items()}
    tx = torch.tensor(x, requires_grad=True)
    got = tda.diff_augment(tx, draws, policy)
    got.backward(torch.tensor(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]), **TOL)


def test_sampled_draws_have_the_jax_ranges():
    """sample_diff_aug_draws gives every key of the policy, in the ranges
    the JAX chain draws from, from a seeded torch.Generator."""
    draws = tda.sample_diff_aug_draws(torch.Generator().manual_seed(0), 4096, 256, 768)
    assert set(draws) == {"brightness", "saturation", "contrast", "t_h", "t_w",
                          "off_h", "off_w"}
    assert -0.5 <= draws["brightness"].min() and draws["brightness"].max() < 0.5
    assert 0 <= draws["saturation"].min() and draws["saturation"].max() < 2
    assert 0.5 <= draws["contrast"].min() and draws["contrast"].max() < 1.5
    assert (draws["t_h"].min(), draws["t_h"].max()) == (-32, 32)
    assert (draws["t_w"].min(), draws["t_w"].max()) == (-96, 96)
    assert (draws["off_h"].min(), draws["off_h"].max()) == (0, 256)
    assert (draws["off_w"].min(), draws["off_w"].max()) == (0, 768)
    again = tda.sample_diff_aug_draws(torch.Generator().manual_seed(0), 4096, 256, 768)
    assert all(torch.equal(draws[k], again[k]) for k in draws)


class _Net(torch.nn.Module):
    """A conv, a linear, an SN embedding, a plain embedding named like G's
    shared one, and 1-D leaves, in the port's layouts."""

    def __init__(self):
        super().__init__()
        self.conv = tsn.SNConv2d(3, 5, 3)
        self.lin = tsn.Linear(6, 4)
        self.embed = tsn.SNEmbedding(7, 9)
        self.shared = tsn.Embedding(5, 6)


def test_ortho_reg_matches_jax():
    """Ortho-reg on every >= 2-D weight in the JAX kernel's (out, fan_in)
    view (conv OIHW and HWIO, linear transposed, embedding as (features, n)),
    skipping 1-D leaves and the blacklisted shared embedding."""
    net = _Net()
    rng = np.random.default_rng(8)
    for p in net.parameters():
        p.data = torch.tensor(rng.standard_normal(tuple(p.shape)).astype(np.float32))
        p.grad = torch.tensor(rng.standard_normal(tuple(p.shape)).astype(np.float32))
    to_jax = {
        "conv": {"kernel": lambda t: t.permute(2, 3, 1, 0), "bias": lambda t: t},
        "lin": {"kernel": lambda t: t.T, "bias": lambda t: t},
        "embed": {"embedding": lambda t: t},
        "shared": {"embedding": lambda t: t},
    }
    port_name = {"kernel": "weight", "embedding": "weight", "bias": "bias"}
    tree = lambda attr: {m: {leaf: jnp.asarray(f(getattr(getattr(net, m), port_name[leaf])
                                                  if attr == "data" else
                                                  getattr(getattr(net, m), port_name[leaf]).grad
                                                  ).detach().numpy())
                             for leaf, f in leaves.items()}
                         for m, leaves in to_jax.items()}
    params, grads = tree("data"), tree("grad")
    want = jax_ortho(grads, params, 1e-2, blacklist=shared_blacklist)
    apply_ortho_reg(net, 1e-2, blacklist=("shared.",))
    got = tree("grad")
    for m, leaves in want.items():
        for leaf, value in leaves.items():
            np.testing.assert_allclose(np.asarray(got[m][leaf]), np.asarray(value),
                                       rtol=1e-5, atol=1e-4, err_msg=f"{m}/{leaf}")
    np.testing.assert_array_equal(np.asarray(got["shared"]["embedding"]),
                                  np.asarray(grads["shared"]["embedding"]))


def test_adam_matches_optax():
    """Three Adam steps with betas (0, 0.999), eps 1e-6, lr 5e-5 on the same
    parameters and gradients (some near eps, one exactly zero). torch and
    optax compute sqrt(v / bc2) in different orders, which can move the
    rounded parameter by one f32 ulp: 2.4e-7 relative (two ulps), 1e-9
    absolute."""
    rng = np.random.default_rng(9)
    w0 = rng.standard_normal((3, 50)).astype(np.float32)
    gs = [rng.standard_normal((3, 50)).astype(np.float32) * np.float32(s)
          for s in (1.0, 1e-6, 3.0)]
    gs[1][0, 0] = 0.0
    tx = optax.adam(5e-5, b1=0.0, b2=0.999, eps=1e-6)
    w, state = jnp.asarray(w0), None
    state = tx.init(w)
    p = torch.nn.Parameter(torch.tensor(w0))
    opt = make_optimizer([p], 5e-5, 0.0, 0.999, 1e-6)
    for g in gs:
        updates, state = tx.update(jnp.asarray(g), state, w)
        w = optax.apply_updates(w, updates)
        p.grad = torch.tensor(g)
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=2.4e-7, atol=1e-9)
    with pytest.raises(NotImplementedError):
        make_optimizer([p], 1e-4, 0.0, 0.999, 1e-6, sched_version="CosAnnealLR")
    with pytest.raises(NotImplementedError):
        make_optimizer([p], 1e-4, 0.0, 0.999, 1e-6, clip_norm=1.0)
