"""Data-parallel training of the port over ``torch.distributed`` (gloo, CPU)
against the port's single-process step and the JAX package's mesh step.

The JAX package's step under ``jax.jit`` with the event axis sharded over a
mesh computes the same function as its single-device step on the global
batch (``tests/test_sharding.py::test_global_bn_equals_single_device``). The
port's sharded step is held to that contract: two spawned ranks of one event
each (``tests/torch_ranks.py``) against

  (a) one process taking both events, from the same weights and draws:
      metrics, gradients, and every updated leaf (parameters, ``u``, ``sv``,
      BN stats, EMA, Adam moments) of a step within 1e-5, with ``split_D``
      true and false and with ``Con_reg`` (whose second step's metrics are
      held to it too), with activation recompute (``remat``, two steps), and
      with D's RRMs over the global batch as one sequence
      (``rrm_full_batch_sequence``, in ``split_D`` and in concat mode with
      the proxy RRM, where the ranks' sequence is ``[f_0; r_0; f_1; r_1]``
      and the single process's ``[F; R]``), and with the prior embedding
      (whose L2 norm spans the global batch, in concat mode ``[F; R]``);
  (b) ``ieagan_tpu.parallel.sharding.make_sharded_train_step`` on a 2-device
      mesh of the conftest's virtual CPU devices, within
      ``tests/test_torch_train_step.py``'s bounds (metrics rtol 2e-3, atol
      2e-5; gradients per leaf max 1e-2, median 1e-3; updates 1e-2), in
      both ``split_D`` modes, with and without the full-batch sequence;
  (c) batch norm alone: G's forward and backward with the global moments
      against one process;
  (d) the two ranks' whole states bit-equal after the steps;
  (e) ``parse_mesh_spec`` on every form the JAX package accepts;
  (f) the control: one process taking rank 0's event alone breaks (a)'s
      bound.

Leaves whose gradient is null in exact arithmetic (conv biases feeding a
batch norm, norm < 1e-5) carry rounding noise, which Adam scales up against
its eps: their gradients are held to stay null, their updates to stay below
the learning rate, as in ``tests/test_torch_train_step.py``.
"""


import contextlib
from concurrent.futures import ThreadPoolExecutor

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ieagan_tpu.core.mesh import make_mesh as jax_make_mesh
from ieagan_tpu.core.mesh import parse_mesh_spec as jax_parse_mesh_spec
from ieagan_tpu.models import Discriminator as JaxD
from ieagan_tpu.models import Generator as JaxG
from ieagan_tpu.parallel import sharding as jax_sharding
from ieagan_tpu.train import init_train_state as jax_init
from ieagan_tpu.train import step as jax_step_module
from ieagan_torch.core import mesh as port_mesh
from ieagan_torch.models.convert import (discriminator_state_from_flax,
                                         generator_state_from_flax)
from ieagan_torch.models.discriminator import Discriminator
from ieagan_torch.models.generator import Generator
from ieagan_torch.ops.image_norm import device_event_transform
from ieagan_torch.parallel import collectives, distributed, sharding
from tests.helpers import tiny_config
from tests.test_torch_discriminator import _randomize_params
from tests.test_torch_eval import few_torch_threads  # noqa: F401 (autouse)
from tests.test_torch_losses import jax_draws
from tests.torch_ranks import (join_processes, rank_targets, run_single, run_step_rank,
                               start_processes)

CONFIG = tiny_config(RRM_prx_G=True, rdof_dim=4, diff_aug=True, compute_dtype="float32")
POLICY = CONFIG["diff_aug_policy"]
CASES = {"split_D": dict(split_D=True), "concat": dict(split_D=False),
         "con_reg": dict(split_D=True, Con_reg=True),
         "remat": dict(split_D=True, remat=True),
         "full_batch": dict(split_D=True, rrm_full_batch_sequence=True),
         "full_batch_concat": dict(split_D=False, rrm_full_batch_sequence=True, RRM_prx_D=True),
         "prior": dict(split_D=False, prior_embed=True)}
JAX_CASES = ("split_D", "concat", "full_batch", "full_batch_concat")
CASES_STEPS = {"split_D": 1, "concat": 1, "con_reg": 2, "remat": 2, "full_batch": 1,
               "full_batch_concat": 1, "prior": 2}
# the prior-feature table of the ``prior`` case (module state, set in each
# process that runs the case)
PRIOR_TABLE = np.random.default_rng(7).uniform(0.5, 2.0, CONFIG["n_classes"])
# The keys of a case that change the architecture, each with the seed of its
# own initial state's biases. A state can put an activation within rounding
# of a ReLU kink; one process and two ranks then take different
# subgradients there (at the proxy RRM's architecture with seed 5, one of
# G's 131,072 pre-ReLU values at the output head flips sign and moves G's
# gradient by up to 3.1e-3, while the ranks and the JAX step on one and on
# two devices agree within 7e-6). These seeds put no value there.
ARCH_SEEDS = {"RRM_prx_D": 1, "prior_embed": 2}
TOL = 1e-5


def _variables(params, state):
    return jax.tree_util.tree_map(np.asarray, {"params": params, "state": state})


def _port_state_dict(module_cls, variables, convert, cfg):
    module = module_cls.from_config(cfg)
    sd = convert(variables, module.state_dict())
    return {k: torch.tensor(v) for k, v in sd.items()}


def _jax_init(cfg):
    """The JAX train state of ``cfg`` from PRNGKey(0)."""
    return jax_init(JaxG.from_config(cfg), JaxD.from_config(cfg), cfg, jax.random.PRNGKey(0))


def _randomized(state, rng):
    """``state`` with biases and SA gammas drawn from ``rng``."""
    params_G = _randomize_params(state.params_G, rng)
    return state.replace(params_G=params_G, params_D=_randomize_params(state.params_D, rng),
                         params_G_ema=jax.tree_util.tree_map(jnp.copy, params_G))


def _port_weights(state, cfg):
    """G, D and G_ema of a JAX state as the port's state dicts."""
    return {
        "G": _port_state_dict(Generator, _variables(state.params_G, state.state_G),
                              generator_state_from_flax, cfg),
        "D": _port_state_dict(Discriminator, _variables(state.params_D, state.state_D),
                              discriminator_state_from_flax, cfg),
        "G_ema": _port_state_dict(Generator, _variables(state.params_G_ema, state.state_G_ema),
                                  generator_state_from_flax, cfg)}


def _rows(item, rows):
    """A scheduled draw (array or dict of arrays) cut to ``rows``."""
    if isinstance(item, dict):
        return {k: v[rows] for k, v in item.items()}
    return item[rows]


@contextlib.contextmanager
def _step_seam(z):
    """The JAX step's z seam and gradient capture for every mesh step built
    inside: its ``make_train_step`` patched to take them."""
    make_step = jax_step_module.make_train_step
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_step_module, "make_train_step",
               lambda G, D, config, spe=0: make_step(G, D, config, spe, z_schedule=z,
                                                     capture_grads=True))
    try:
        yield
    finally:
        mp.undo()


def _jax_mesh_step(state, cfg, x, y, rdof, key, mesh, tensor_parallel=False):
    """``make_sharded_train_step`` on ``mesh`` (inside ``_step_seam``) with
    rdof written into G's ``linear_f`` input, D phase then G phase, the
    state placed by ``place_state`` (split over the model axis with
    ``tensor_parallel``). Flax's method interceptors are per thread, so
    several cases run at once."""
    rdof_iter = iter(rdof)

    def interceptor(next_fun, args, kwargs, context):
        if context.module.name == "linear_f" and context.method_name == "__call__":
            args = (args[0].at[:, -4:].set(jnp.asarray(next(rdof_iter))),) + tuple(args[1:])
        return next_fun(*args, **kwargs)

    jG, jD = JaxG.from_config(cfg), JaxD.from_config(cfg)
    step = jax_sharding.make_sharded_train_step(jG, jD, cfg, mesh,
                                                tensor_parallel=tensor_parallel)
    # the step donates its state: it takes a copy
    placed = jax_sharding.place_state(jax.tree_util.tree_map(jnp.copy, state), mesh,
                                      tensor_parallel=tensor_parallel)
    with nn.intercept_methods(interceptor):
        new_state, mets = step(placed, x, y, key)
    jax.block_until_ready(new_state.params_G)
    assert next(rdof_iter, None) is None
    return new_state, mets


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case through two spawned ranks and one process, and the JAX
    mesh step of the JAX cases; returns (initial JAX states by case, JAX
    results by case, the ranks' results, the single process's, the
    control's). A case that changes the architecture (``ARCH_SEEDS``) starts
    from a state of its own, every other case from one shared state."""
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    es, epb = CONFIG["n_classes"], CONFIG["events_per_batch"]
    b = es * epb
    configs = {name: dict(CONFIG, **case) for name, case in CASES.items()}
    seeds = {name: next((s for k, s in ARCH_SEEDS.items() if cfg[k]), None)
             for name, cfg in configs.items()}
    arch = [name for name in configs if seeds[name] is not None]
    # the JAX inits compile at once (XLA releases the GIL); each state's
    # draws follow, in the order of the generators' use
    with ThreadPoolExecutor(1 + len(arch)) as pool:
        inits = list(pool.map(_jax_init, [CONFIG] + [configs[name] for name in arch]))
    rng = np.random.default_rng(0)
    state = _randomized(inits[0], rng)
    x = rng.uniform(-1, 1, (b, 32, 32, 1)).astype(np.float32)
    y = np.tile(np.arange(es, dtype=np.int32), epb)
    z = [rng.standard_normal((b, CONFIG["dim_z"])).astype(np.float32) for _ in range(2)]
    rdof = [rng.standard_normal((b, 4)).astype(np.float32) for _ in range(2)]
    key = jax.random.PRNGKey(9)
    key1, _, _, kaug_d = jax.random.split(key, 4)
    _, _, _, kaug_g = jax.random.split(key1, 4)
    schedule = [z[0], rdof[0], jax_draws(kaug_d, x.shape, POLICY),
                jax_draws(jax.random.fold_in(kaug_d, 7), x.shape, POLICY),
                z[1], rdof[1], jax_draws(kaug_g, x.shape, POLICY)]

    states = dict.fromkeys(configs, state)
    states.update({name: _randomized(init, np.random.default_rng(seeds[name]))
                   for name, init in zip(arch, inits[1:])})

    weights = _port_weights(state, CONFIG)
    xt, yt = torch.tensor(x), torch.tensor(y).long()
    cases = [dict(_port_weights(states[name], cfg), config=cfg, x=xt, y=yt,
                  **(dict(steps=1, schedule=[schedule]) if name in JAX_CASES
                     else dict(steps=2, seed=3)),
                  **(dict(prior=PRIOR_TABLE) if cfg["prior_embed"] else {}))
             for name, cfg in configs.items()]
    g = torch.Generator().manual_seed(1)
    bn = dict(config=CONFIG, G=weights["G"], z=torch.randn((b, CONFIG["dim_z"]), generator=g),
              y=yt, rdof=torch.randn((b, 4), generator=g),
              w=torch.randn((b, 32, 32, 1), generator=g))
    half = slice(0, b // 2)
    control = [dict(cases[0], x=xt[half], y=yt[half],
                    schedule=[[_rows(item, half) for item in schedule]])]
    out = tmp_path_factory.mktemp("ranks")
    job = str(out / "job.pt")
    torch.save({"bn": bn, "cases": cases, "control": control}, job)
    # the two ranks and the single process run while the JAX mesh steps
    # compile here, each case in a thread of its own
    procs = start_processes(rank_targets(run_step_rank, 2, (str(out / "init"), job, str(out)))
                            + [(run_single, (job, str(out)))])
    try:
        mesh = jax_make_mesh(n_data=2)
        with _step_seam(z), ThreadPoolExecutor(len(JAX_CASES)) as pool:
            futures = {name: pool.submit(_jax_mesh_step, states[name], configs[name], x, y,
                                         rdof, key, mesh)
                       for name in JAX_CASES}
            jax_results = {name: f.result() for name, f in futures.items()}
    finally:
        join_processes(procs)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in (0, 1)]
    single = torch.load(out / "single.pt", weights_only=False)
    return states, jax_results, ranks, single, single.pop("control")[0]


def _leaf_errors(got: dict, want: dict):
    """Per-leaf ||got - want|| / ||want|| of two gradient dicts; leaves null
    in exact arithmetic (norm < 1e-5) must be null in both and are left out."""
    assert set(got) == set(want)
    errs = {}
    for name, w in want.items():
        g, w = torch.as_tensor(got[name]).double(), torch.as_tensor(np.asarray(w)).double()
        if float(w.norm()) < 1e-5:
            assert float(g.norm()) < 1e-5, name
            continue
        errs[name] = float((g - w).norm() / w.norm())
    return errs


def _case(runs, name):
    _, _, ranks, single, _ = runs
    i = list(CASES).index(name)
    return ranks[0]["cases"][i], ranks[1]["cases"][i], single["cases"][i]


@pytest.fixture(scope="module")
def initial(runs):
    """The port's state dicts of G, D and G_ema before the steps, by case."""
    return {name: _port_weights(runs[0][name], dict(CONFIG, **case))
            for name, case in CASES.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_metrics_equal_one_process(runs, name):
    got, _, want = _case(runs, name)
    assert len(got["metrics"]) == len(want["metrics"]) == CASES_STEPS[name]
    for g, w in zip(got["metrics"], want["metrics"]):
        assert set(g) == set(w) and len(w) == 6
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=TOL, atol=TOL, err_msg=k)


@pytest.mark.parametrize("net", ["G", "D"])
@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_gradients_equal_one_process(runs, name, net):
    """The gradients each optimizer took (averaged over the ranks, then
    ortho-reg), leaf for leaf, in the first step."""
    got, _, want = _case(runs, name)
    errs = _leaf_errors(got["grads"][net], want["grads"][net])
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    assert len(errs) > 20 and max(errs.values()) < TOL, worst


@pytest.mark.parametrize("net", ["G", "D", "G_ema"])
@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_updated_state_equals_one_process(runs, initial, name, net):
    """After the first step: every buffer (``u``, ``sv``, BN stats, the
    standing counter) and, for G_ema, every tensor within 1e-5; every
    parameter of G and D within 1e-5 of the single process's, except the
    leaves with a null gradient, which moved by less than the learning rate
    on both sides; Adam's moments of the leaves with a real gradient within
    1e-5 relative."""
    got, _, want = _case(runs, name)
    lr = CONFIG[f"{net}_lr"] if net != "G_ema" else CONFIG["G_lr"]
    params = set() if net == "G_ema" else {
        n for n, _ in (Generator if net == "G" else Discriminator).from_config(
            dict(CONFIG, **CASES[name])).named_parameters()}
    grads = {} if net == "G_ema" else want["grads"][net]
    before = initial[name][net]
    for k, w in want["state"][net].items():
        g = got["state"][net][k]
        if k in params and float(grads[k].norm()) < 1e-5:
            assert float((g - before[k]).abs().max()) < lr, k
            assert float((w - before[k]).abs().max()) < lr, k
            continue
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL, atol=TOL, err_msg=k)
    if net == "G_ema":
        return
    for k, moments in want["moments"][net].items():
        if float(grads[k].norm()) < 1e-5:
            continue
        for m, w in moments.items():
            g = got["moments"][net][k][m]
            assert float((g - w).norm()) <= TOL * float(w.norm()) + 1e-12, (k, m)


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_hold_bit_equal_states(runs, name):
    """Every tensor of both ranks' states (G, D, G_ema, Adam moments) and
    their counts, equal bit for bit after the steps."""
    r0, r1, _ = _case(runs, name)
    assert r0["digest"] == r1["digest"]
    assert len(r0["digest"]) > 100


@pytest.mark.parametrize("name", JAX_CASES)
def test_two_ranks_match_jax_mesh_step(runs, name):
    """Metrics, gradients leaf for leaf, and the updates of G and D against
    the JAX package's sharded step on a 2-device mesh, within
    ``tests/test_torch_train_step.py``'s bounds."""
    states, jax_results, *_ = runs
    state = states[name]
    got = _case(runs, name)[0]
    new_state, jmets = jax_results[name]
    for k, v in got["metrics"][0].items():
        np.testing.assert_allclose(v, float(jmets[k]), rtol=2e-3, atol=2e-5, err_msg=k)
    for net, convert in (("G", generator_state_from_flax), ("D", discriminator_state_from_flax)):
        want = convert({"params": jax.tree_util.tree_map(np.asarray, jmets[f"_grads_{net}"])})
        errs = _leaf_errors(got["grads"][net], want)
        worst = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
        assert max(errs.values()) < 1e-2 and np.median(list(errs.values())) < 1e-3, (net, worst)
        params = lambda s: getattr(s, f"params_{net}")
        before = convert(_variables(params(state), getattr(state, f"state_{net}")))
        after = convert(_variables(params(new_state), getattr(new_state, f"state_{net}")))
        lr = CONFIG[f"{net}_lr"]
        for k, w in after.items():
            g = got["state"][net][k].numpy()
            if k not in got["grads"][net]:  # u, sv, BN stats
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=k)
                continue
            step_got, step_want = g - before[k], w - before[k]
            if np.linalg.norm(want[k]) < 1e-5:
                assert np.abs(step_got).max() < lr and np.abs(step_want).max() < lr, k
                continue
            err = np.linalg.norm(step_got - step_want) / np.linalg.norm(step_want)
            assert err < 1e-2, (net, k, err)


def test_global_batch_norm_equals_one_process(runs):
    """Twin of ``test_global_bn_equals_single_device``: G's train-mode
    forward on two ranks with the global moments gives the single process's
    output rows and running stats, and its backward (through the moments'
    all-reduce) the single process's gradients."""
    _, _, ranks, single, _ = runs
    want = single["bn"]
    out = torch.cat([r["bn"]["out"] for r in ranks])
    np.testing.assert_allclose(out.numpy(), want["out"].numpy(), rtol=0, atol=1e-5)
    n_bn = 0
    for k, w in want["buffers"].items():
        for r in ranks:
            np.testing.assert_allclose(r["bn"]["buffers"][k].numpy(), w.numpy(), rtol=TOL,
                                       atol=TOL, err_msg=k)
        n_bn += k.endswith(".var")
    assert n_bn >= 4
    for r in ranks:
        errs = _leaf_errors(r["bn"]["grads"], want["grads"])
        assert len(errs) > 20 and max(errs.values()) < TOL, sorted(
            errs.items(), key=lambda kv: -kv[1])[:3]


def test_one_event_alone_breaks_the_bound(runs):
    """The control: one process on rank 0's event alone (its rows of the
    same draws) is not what the two ranks compute."""
    *_, control = runs
    got = _case(runs, "split_D")[0]
    metric_gap = max(abs(got["metrics"][0][k] - v) / max(abs(v), TOL)
                     for k, v in control["metrics"][0].items())
    grad_gap = max(max(_leaf_errors(got["grads"][net], control["grads"][net]).values())
                   for net in ("G", "D"))
    assert metric_gap > 10 * TOL and grad_gap > 10 * TOL, (metric_gap, grad_gap)


@pytest.mark.parametrize("spec", [{"data": 4}, {"data": 2, "model": 2}, {"model": 2}, "4x2",
                                  "1x1", "8", " 2 ", "data:4,model:2", "model:2", "DATA:3",
                                  4, 1])
def test_parse_mesh_spec_matches_jax(spec):
    assert port_mesh.parse_mesh_spec(spec) == jax_parse_mesh_spec(spec)


def test_make_mesh_spans_the_world_and_refuses_a_model_axis():
    """One process: the data axis is 1 and every collective the identity;
    a mesh wider than the world is refused, on either axis (a 1x2 mesh
    needs two processes: tensor parallelism, ``tests/test_torch_tensor_parallel.py``)."""
    mesh = port_mesh.make_mesh()
    assert (mesh.n_data, mesh.rank, mesh.shape) == (1, 0, {"data": 1, "model": 1})
    with pytest.raises(ValueError, match="world of 1"):
        port_mesh.make_mesh(1, 2)
    with pytest.raises(ValueError, match="world of 1"):
        port_mesh.make_mesh(2)
    x = torch.randn(4, 3, requires_grad=True)
    assert collectives.all_reduce_sum(x, mesh) is x
    assert collectives.all_gather_rows(x, mesh) is x
    assert sharding.host_local_batch(mesh, x) is x


def test_device_transform_noise_is_the_global_batch_rows():
    """The uint8 transform of a rank's rows draws its noise for the global
    batch and keeps its rows: rank 1 of 2 gets rows 4-7 of the global
    batch's transform from a generator in the same state."""
    raw = torch.randint(0, 256, (8, 6, 5), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(0))
    whole = device_event_transform(raw, torch.Generator().manual_seed(1))
    mesh = port_mesh.Mesh(n_data=2, rank=1)
    local = sharding.host_local_batch(mesh, raw)
    part = device_event_transform(local, torch.Generator().manual_seed(1), rows=(4, 8))
    assert part.shape == (4, 12, 5, 1)
    torch.testing.assert_close(part, whole[4:], rtol=0, atol=0)


def test_initialize_is_a_no_op_without_a_launcher(monkeypatch):
    """Without ``WORLD_SIZE``/``MASTER_ADDR`` no group is joined (the JAX
    twin without a coordinator); the helpers then report one process."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    distributed.initialize(device_type="cpu")
    assert not torch.distributed.is_initialized()
    assert (distributed.world_size(), distributed.rank(), distributed.is_multiprocess()) == (
        1, 0, False)
    assert distributed.broadcast_object({"a": 1}) == {"a": 1}
    assert distributed.local_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert distributed.local_device("cuda") == torch.device("cuda", 3)
