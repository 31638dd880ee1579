"""The port's optimizers and LR schedules against optax, and the map between
the port's optimizer state and optax's state tree.

``ieagan_tpu/train/optim.py::make_optimizer`` builds the optax chain the JAX
package trains with; ``ieagan_torch/train/optim.py::make_optimizer`` is its
twin. Both run 20 steps of the same seeded gradients from the same weights,
under every variant (Adam, AMSGrad, AdaBelief), with and without
``clip_by_global_norm`` (the gradients' norms straddle the threshold), and
under the three schedules. optax runs op by op, as its formulas read: under
``jax.jit`` XLA:CPU contracts products and sums into fused multiply-adds,
which moves AdaBelief's second moment by an f32 ulp from the first step, and
the belief's small denominators amplify that (1e-5 relative on the weights
by step 16). Tolerance: the weights within rtol 2e-6 and atol 3e-8 (a
millionth of one update, lr 3e-2 times a normalized step of order one) after
every step; measured ~1e-7 relative, and 1.9e-8 absolute where AdaBelief's
small denominators amplify one ulp of the clipped gradients' global norm
(summed in another order by XLA). The schedules alone: within rtol 1e-6 of optax's at every
count. An optimizer carried over by ``copy.deepcopy``, pickling or
``state_dict``/``load_state_dict`` continues its step sequence bit for bit.
"""

import copy
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from ieagan_tpu.train.optim import make_lr_schedule as jax_schedule
from ieagan_tpu.train.optim import make_optimizer as jax_optimizer
from ieagan_torch.models.convert import (discriminator_state_to_flax, optimizer_state_from_flax,
                                         optimizer_state_to_flax, params_to_flax)
from ieagan_torch.models.discriminator import Discriminator
from ieagan_torch.train.optim import make_lr_schedule, make_optimizer
from tests.helpers import tiny_config
from tests.test_torch_eval import few_torch_threads  # noqa: F401 (autouse)

STEPS = 20
RTOL, ATOL = 2e-6, 3e-8
VARIANTS = {"adam": {}, "amsgrad": {"amsgrad": True}, "adabelief": {"ada_belief": True}}
# (sched_version, num_epochs, steps_per_epoch): CosAnnealLR over 5 epochs of 2
# steps (the cosine reaches its floor halfway), CosAnnealWarmRes at one step
# per epoch (a restart at epoch 10)
SCHEDULES = [("default", 5, 2), ("CosAnnealLR", 5, 2), ("CosAnnealWarmRes", 20, 1)]


def _gradients(seed: int, shapes):
    """Seeded gradients whose global norm crosses 1.0 both ways."""
    rng = np.random.default_rng(seed)
    scales = np.geomspace(0.05, 20.0, STEPS)
    rng.shuffle(scales)
    return [[(rng.standard_normal(s) * sc / np.sqrt(np.prod(s))).astype(np.float32)
             for s in shapes] for sc in scales]


@pytest.mark.parametrize("sched", SCHEDULES, ids=lambda s: s[0])
def test_schedules_match_optax(sched):
    version, num_epochs, spe = sched
    ours, theirs = (make_lr_schedule(2e-4, version, num_epochs, spe),
                    jax_schedule(2e-4, version, num_epochs, spe))
    for count in range(60):
        want = float(theirs(jnp.asarray(count, jnp.int32)) if callable(theirs) else theirs)
        got = ours(count) if callable(ours) else ours
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=f"{version} @ {count}")


@pytest.mark.parametrize("clip", [None, 1.0], ids=["noclip", "clip"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("sched", SCHEDULES, ids=lambda s: s[0])
def test_optimizer_matches_optax(variant, clip, sched):
    version, num_epochs, spe = sched
    shapes = [(6, 7), (5,)]
    rng = np.random.default_rng(3)
    w0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tx = jax_optimizer(jax_schedule(3e-2, version, num_epochs, spe), 0.5, 0.999, 1e-6,
                       clip_norm=clip, **VARIANTS[variant])
    update = tx.update
    w = [jnp.asarray(a) for a in w0]
    state = tx.init(w)
    ps = [torch.nn.Parameter(torch.tensor(a)) for a in w0]
    lr = make_lr_schedule(3e-2, version, num_epochs, spe)
    opt = make_optimizer(ps, 0.5, 0.999, 1e-6, clip_norm=clip, **VARIANTS[variant])
    for i, grads in enumerate(_gradients(7, shapes)):
        updates, state = update([jnp.asarray(g) for g in grads], state, w)
        w = optax.apply_updates(w, updates)
        for p, g in zip(ps, grads):
            p.grad = torch.tensor(g)
        opt.step(lr)
        for p, want in zip(ps, w):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), rtol=RTOL,
                                       atol=ATOL, err_msg=f"step {i + 1}")
    assert opt.count == opt.sched_count == STEPS


@pytest.fixture(scope="module")
def tiny_d():
    torch.manual_seed(0)
    D = Discriminator.from_config(tiny_config())
    D.reset_parameters(torch.Generator().manual_seed(0))
    return D


@pytest.mark.parametrize("clip", [None, 1.0], ids=["noclip", "clip"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_state_map_both_directions(tiny_d, variant, clip):
    """Three steps of optax on D's flax params tree and of the port on D: the
    port's state written as an optax tree equals optax's, leaf for leaf
    (rtol 2e-6); optax's state read into a fresh port optimizer comes back out
    exactly; a tree of another chain (clip or no clip) is refused."""
    D = tiny_d
    params0 = {n: p.detach().clone() for n, p in D.named_parameters()}
    tx = jax_optimizer(1e-3, 0.0, 0.999, 1e-6, clip_norm=clip, **VARIANTS[variant])
    flax_params = discriminator_state_to_flax(D)["params"]
    jstate = tx.init(flax_params)
    opt = make_optimizer(D.parameters(), 0.0, 0.999, 1e-6, clip_norm=clip,
                         **VARIANTS[variant])
    rng = np.random.default_rng(5)
    for _ in range(3):
        grads = {n: torch.tensor(rng.standard_normal(p.shape).astype(np.float32))
                 for n, p in D.named_parameters()}
        for n, p in D.named_parameters():
            p.grad = grads[n]
        opt.step(1e-3)
        _, jstate = tx.update(params_to_flax(D, grads), jstate, flax_params)
    want = serialization.to_state_dict(jstate)
    got = optimizer_state_to_flax(opt, D)
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, want))[0])
    assert flat_got.keys() == flat_want.keys()
    for path, value in flat_want.items():
        assert flat_got[path].dtype == value.dtype, path
        np.testing.assert_allclose(flat_got[path], value, rtol=RTOL, atol=0, err_msg=str(path))

    with torch.no_grad():
        for n, p in D.named_parameters():
            p.copy_(params0[n])
    fresh = make_optimizer(D.parameters(), 0.0, 0.999, 1e-6, clip_norm=clip,
                           **VARIANTS[variant])
    optimizer_state_from_flax(fresh, D, jax.tree_util.tree_map(np.asarray, want))
    back = dict(jax.tree_util.tree_flatten_with_path(optimizer_state_to_flax(fresh, D))[0])
    for path, value in flat_want.items():
        np.testing.assert_array_equal(back[path], value, err_msg=str(path))
    other = make_optimizer(D.parameters(), 0.0, 0.999, 1e-6,
                           clip_norm=None if clip else 1.0, **VARIANTS[variant])
    with pytest.raises(KeyError):
        optimizer_state_from_flax(other, D, jax.tree_util.tree_map(np.asarray, want))
    with torch.no_grad():
        for n, p in D.named_parameters():
            p.copy_(params0[n])


# (variant, clip_norm, schedule) of the round trips: plain Adam; AMSGrad
# behind the clip (its third moment, the clip's threshold); AdaBelief under a
# cosine schedule of one step per epoch (the schedule's count moves the rate)
ROUND_TRIPS = [("adam", None, "default"), ("amsgrad", 1.0, "default"),
               ("adabelief", None, "CosAnnealLR")]


def _copy_by_state_dict(opt, params, variant, clip):
    """A fresh optimizer over copies of ``params`` that loads ``opt``'s
    ``state_dict``."""
    fresh = [torch.nn.Parameter(p.detach().clone()) for p in params]
    other = make_optimizer(fresh, 0.5, 0.999, 1e-6, clip_norm=clip, **VARIANTS[variant])
    other.load_state_dict(opt.state_dict())
    return other, fresh


def _copy_by(how, opt, params, variant, clip):
    """``opt`` and its parameters carried over by ``how``: a deep copy, a
    pickle round trip, or a ``state_dict`` loaded into a fresh optimizer."""
    if how == "state_dict":
        return _copy_by_state_dict(opt, params, variant, clip)
    copied = (copy.deepcopy(opt) if how == "deepcopy"
              else pickle.loads(pickle.dumps(opt)))
    return copied, copied.params


@pytest.mark.parametrize("how", ["deepcopy", "pickle", "state_dict"])
@pytest.mark.parametrize("case", ROUND_TRIPS, ids=lambda c: c[0])
def test_carried_optimizer_continues_bit_for_bit(case, how):
    """Three steps, then the optimizer carried over by ``how``: the copy and
    the original take three more steps of the same gradients to the same
    weights, moments and counts, bit for bit (the copy keeps ``clip_norm``,
    the variant, Adam's count and the schedule's count)."""
    variant, clip, version = case
    lr = make_lr_schedule(3e-2, version, 6, 1)
    shapes = [(6, 7), (5,)]
    rng = np.random.default_rng(11)
    params = [torch.nn.Parameter(torch.tensor(rng.standard_normal(s).astype(np.float32)))
              for s in shapes]
    opt = make_optimizer(params, 0.5, 0.999, 1e-6, clip_norm=clip, **VARIANTS[variant])
    grads = _gradients(13, shapes)

    def step(o, ps, i):
        for p, g in zip(ps, grads[i]):
            p.grad = torch.tensor(g)
        o.step(lr)

    for i in range(3):
        step(opt, params, i)
    other, other_params = _copy_by(how, opt, params, variant, clip)
    assert (other.variant, other.clip_norm, other.count, other.sched_count) == (
        variant, clip, 3, 3)
    for i in range(3, 6):
        step(opt, params, i)
        step(other, other_params, i)
        for p, q in zip(params, other_params):
            assert torch.equal(p, q), f"step {i + 1}"
    for p, q in zip(params, other_params):
        for m in opt.moment_names:
            assert torch.equal(opt.state[p][m], other.state[q][m]), m
    assert (other.count, other.sched_count) == (opt.count, opt.sched_count) == (6, 6)


def test_load_state_dict_refuses_another_variant():
    params = [torch.nn.Parameter(torch.zeros(3))]
    adam = make_optimizer(params, 0.0, 0.999, 1e-6)
    for variant in ("amsgrad", "adabelief"):
        other = make_optimizer(params, 0.0, 0.999, 1e-6, **VARIANTS[variant])
        with pytest.raises(ValueError, match="of 'adam'"):
            other.load_state_dict(adam.state_dict())
