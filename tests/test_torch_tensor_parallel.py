"""Tensor parallelism of the port (the mesh's ``model`` axis) over
``torch.distributed`` (gloo, CPU) against the port's single-process step and
the JAX package's sharded step.

``ieagan_tpu/parallel/sharding.py`` splits a leaf over the ``"model"`` axis
by its sharding and lets GSPMD place the collectives; the sharded step
computes what the replicated step computes (``tests/test_sharding.py:64``).
The port's split layers (``ieagan_torch/parallel/tensor.py``) are held to
that:

  (a) ``param_split`` gives every leaf of the flagship G and D the split of
      ``param_shardings(..., tensor_parallel=True)`` at ``model`` 2 and 4
      (from ``jax.eval_shape``, nothing compiled), with its counts (G 112
      column and 2 row leaves, D 44 and 3), and a split layer takes every
      split leaf;
  (b) one port step on a 1x2 mesh (two ranks) and on a 2x2 mesh (four
      ranks) of the case ``clip_remat`` (``clip_norm``, activation
      recompute and D's ortho-reg on the flagship's options) against
      ``make_sharded_train_step(..., tensor_parallel=True)`` on a 2x2 mesh
      of the conftest's virtual devices, within
      ``tests/test_torch_parallel.py``'s bounds (metrics rtol 2e-3, atol
      2e-5; gradients per leaf max 1e-2, median 1e-3; updates 1e-2), both
      in float32; and two steps in float64 against the port's one process
      in float64 within 1e-5 (``TOL``), and so the case ``base`` (no clip,
      no recompute) on the 1x2 mesh: metrics, gradients and every updated
      leaf gathered whole (parameters, G_ema, Adam moments, SN ``u``/``sv``,
      BN stats). ``CONFIG`` is wide enough for the rule to split every kind
      of leaf (counted in ``test_the_width_splits_every_kind_of_leaf``);
      ``clip_norm``'s global norm spans the model axis, and clips;
  (c) the RRM's attention with 2 heads at ``model`` 4 (heads not dividing
      the axis: qkv gathered, ``o_proj`` split) against one process;
  (d) after two steps every replicated leaf is bit-equal across the model
      ranks, and each rank holds 1/M of every split leaf, its Adam moments
      and its G_ema twin;
  (e) a checkpoint written under 1x2 loads in one process, and one written
      by one process loads under 1x2 and is written back byte for byte;
  (f) ``train_torch.py --mesh 1x2`` (the CLI in two ranks): two steps, a
      save, a resume to step 3.

The initial state is the port's random init (random biases and SA gammas)
from ``STATE_SEED``, carried to the JAX package by the port's converter.
The split layers sum in another order than one process, and two correct
programs can take different subgradients where a pre-ReLU value sits within
rounding of zero (``tests/test_torch_parallel.py``'s ``ARCH_SEEDS`` note):
in float32 at these widths most initial states put some value there, and a
gradient leaf then moves by 1e-4-3e-3. The comparisons with one process
therefore run in float64 (``tests/torch_ranks.py::float64_compute``), where
rounding decides no subgradient, at any seed. The JAX step runs in float32
only; at ``STATE_SEED`` it takes the subgradients the port takes in float32
and in float64. At seed 0 it does not: one element of D's
``blocks_0_0.conv1.bias`` gradient reads 2.07e-4 in the JAX step and 3.86e-4
in the port's float32 and float64 steps, and under ``clip_norm`` Adam's
first update of that element is in its linear range, so the leaf's update
misses the 1e-2 bound (2.9e-2) while its gradient meets the gradient bounds.
"""

import concurrent.futures
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ieagan_tpu.core.config import DEFAULT_CONFIG as JAX_DEFAULT_CONFIG
from ieagan_tpu.core.mesh import make_mesh as jax_make_mesh
from ieagan_tpu.models import Discriminator as JaxD
from ieagan_tpu.models import Generator as JaxG
from ieagan_tpu.parallel.sharding import param_shardings
from ieagan_tpu.train import init_train_state as jax_init
from ieagan_tpu.train.step import TrainState as JaxTrainState
from ieagan_tpu.train.step import make_optimizers as jax_make_optimizers
from ieagan_torch.core.mesh import Mesh
from ieagan_torch.models.convert import (_flax_param_layout, discriminator_state_from_flax,
                                         discriminator_state_to_flax, generator_state_from_flax,
                                         generator_state_to_flax)
from ieagan_torch.models.discriminator import Discriminator
from ieagan_torch.models.generator import Generator
from ieagan_torch.ops.rrm import MultiheadSelfAttention
from ieagan_torch.ops.spectral import Linear, SNConv2d, SNEmbedding, SNLinear
from ieagan_torch.parallel import tensor
from ieagan_torch.parallel.sharding import param_split, split_rule
from ieagan_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from ieagan_torch.utils.flax_msgpack import read_checkpoint
from tests.helpers import tiny_config
from tests.test_torch_eval import few_torch_threads  # noqa: F401 (autouse)
from tests.test_torch_losses import jax_draws
from tests.test_torch_parallel import _jax_mesh_step, _leaf_errors, _step_seam, _variables
from tests.torch_ranks import (case_state, free_port, join_processes, rank_targets,
                               run_cli_rank, run_single, run_tp_rank, start_processes)

CONFIG = tiny_config(RRM_prx_G=True, rdof_dim=4, diff_aug=True, compute_dtype="float32",
                     G_ch=16, D_ch=32)
POLICY = CONFIG["diff_aug_policy"]
CASES = {"base": dict(split_D=True),
         "clip_remat": dict(split_D=True, clip_norm=0.5, remat=True, D_ortho=1e-4)}
JAX_CASE = "clip_remat"
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
STATE_SEED = 4
TOL = 1e-5


def initial_state(seed, cfg):
    """The cases' initial weights from ``seed``: the port's random init with
    random biases and SA gammas, as the port's state dicts of G, D and
    G_ema, and as the JAX package's ``TrainState`` for ``cfg`` (through the
    port's converter; fresh Adam moments from the JAX package's own
    optimizers)."""
    g = torch.Generator().manual_seed(seed)
    G, D = Generator.from_config(CONFIG), Discriminator.from_config(CONFIG)
    for module in (G, D):
        module.reset_parameters(g)
        with torch.no_grad():
            for name, p in module.named_parameters():
                if name.endswith(("bias", "gamma")):
                    p.copy_(torch.randn(p.shape, generator=g) * 0.1
                            + 0.3 * name.endswith("gamma"))
    weights = {"G": G.state_dict(), "D": D.state_dict(),
               "G_ema": {k: v.clone() for k, v in G.state_dict().items()}}
    gv, dv = generator_state_to_flax(G), discriminator_state_to_flax(D)
    g_tx, d_tx = jax_make_optimizers(cfg)
    copy = lambda tree: jax.tree_util.tree_map(jnp.array, tree)
    state = JaxTrainState(params_G=copy(gv["params"]), params_D=copy(dv["params"]),
                          state_G=copy(gv["state"]), state_D=copy(dv["state"]),
                          opt_G=g_tx.init(copy(gv["params"])),
                          opt_D=d_tx.init(copy(dv["params"])),
                          params_G_ema=copy(gv["params"]), state_G_ema=copy(gv["state"]),
                          itr=jnp.zeros((), jnp.int32))
    return weights, state


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The cases through the 1x2 ranks, the 2x2 ranks and one process (two
    steps each in float64, the first from the JAX step's draws, and one
    step of ``JAX_CASE`` in float32 on each mesh), the checkpoint round trip
    under 1x2, the split attention at ``model`` 4 and the CLI's two runs
    under ``--mesh 1x2``; meanwhile the JAX sharded step of ``JAX_CASE`` on
    a 2x2 mesh. Returns (initial JAX state, the JAX step's state and
    metrics, the ranks' results by mesh, the single process's, the jobs and
    the dirs)."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    out = tmp_path_factory.mktemp("tp")
    # the CLI's runs (test_tp_driver_run) need nothing of JAX: they run in a
    # thread while the rest is made
    pool = concurrent.futures.ThreadPoolExecutor(1)
    cli = pool.submit(_cli_runs, out / "cli")
    procs = []
    try:
        es, epb = CONFIG["n_classes"], CONFIG["events_per_batch"]
        b = es * epb
        configs = {name: dict(CONFIG, **case) for name, case in CASES.items()}
        weights, state = initial_state(STATE_SEED, configs[JAX_CASE])
        rng = np.random.default_rng(1)
        x = rng.uniform(-1, 1, (b, 32, 32, 1)).astype(np.float32)
        y = np.tile(np.arange(es, dtype=np.int32), epb)
        z = [rng.standard_normal((b, CONFIG["dim_z"])).astype(np.float32) for _ in range(4)]
        rdof = [rng.standard_normal((b, 4)).astype(np.float32) for _ in range(4)]
        key = jax.random.PRNGKey(9)
        schedules = []
        for i, k in enumerate((key, jax.random.PRNGKey(10))):
            k1, _, _, kaug_d = jax.random.split(k, 4)
            _, _, _, kaug_g = jax.random.split(k1, 4)
            schedules.append([z[2 * i], rdof[2 * i], jax_draws(kaug_d, x.shape, POLICY),
                              jax_draws(jax.random.fold_in(kaug_d, 7), x.shape, POLICY),
                              z[2 * i + 1], rdof[2 * i + 1],
                              jax_draws(kaug_g, x.shape, POLICY)])
        xt, yt = torch.tensor(x), torch.tensor(y).long()
        cases = {(name, bits): dict(weights, config=cfg, x=xt, y=yt, steps=2 if bits == 64 else 1,
                                    schedule=schedules, float64=bits == 64)
                 for name, cfg in configs.items() for bits in (32, 64)}
        # a one-process checkpoint with Adam moments and counts of its own
        base = cases["base", 32]
        one0 = case_state(base, None)
        g = torch.Generator().manual_seed(5)
        for opt in (one0.opt_G, one0.opt_D):
            for p in opt.params:
                for m in opt.moment_names:
                    opt.state[p][m].copy_(torch.rand(p.shape, generator=g))
            opt.count = opt.sched_count = 5
        one0.itr = 5
        save_checkpoint(out / "one0", one0, {}, "copy5")
        heads = MultiheadSelfAttention(128, 2, Linear)
        for m in (heads.qkv_proj, heads.o_proj):
            m.reset_parameters(g)
            torch.nn.init.normal_(m.bias, std=0.1, generator=g)
        attention = dict(dim=128, heads=2, weights=heads.state_dict(),
                         x=torch.randn((3, 8, 128), generator=g),
                         w=torch.randn((3, 8, 128), generator=g))
        saves = {"1x2": "tp12", "single": "one"}
        jobs = {name: dict(cases=[dict(cases[c], save=str(out / saves[name]))
                                  if c == ("clip_remat", 64) and name in saves else cases[c]
                                  for c in JOB_CASES[name]])
                for name in JOB_CASES}
        jobs["1x2"].update(mesh=MESHES["1x2"], checkpoint=dict(
            case=base, load=(str(out / "one0"), "copy5"), resave=str(out / "resave12")))
        jobs["2x2"].update(mesh=MESHES["2x2"], attention=attention)
        targets = []
        for name, job in jobs.items():
            (out / name).mkdir()
            torch.save(job, out / name / "job.pt")
            if name == "single":
                targets.append((run_single, (str(out / name / "job.pt"), str(out / name))))
            else:
                world = job["mesh"][0] * job["mesh"][1]
                targets += rank_targets(run_tp_rank, world, (str(out / name / "init"),
                                                             str(out / name / "job.pt"),
                                                             str(out / name)))
        procs = start_processes(targets)
        with _step_seam(z[:2]):
            jax_result = _jax_mesh_step(state, configs[JAX_CASE], x, y, rdof[:2], key,
                                        jax_make_mesh(n_data=2, n_model=2),
                                        tensor_parallel=True)
    finally:
        try:
            join_processes(procs)
        finally:
            pool.shutdown()
            cli.result()
    ranks = {name: [torch.load(out / name / f"rank{r}.pt", weights_only=False)
                    for r in range(job["mesh"][0] * job["mesh"][1])]
             for name, job in jobs.items() if name != "single"}
    single = torch.load(out / "single" / "single.pt", weights_only=False)
    return state, jax_result, ranks, single, dict(jobs, dir=out, attention=attention,
                                                  cli=out / "cli")


# the cases each job runs, in its order, by (name, bits): the one-process
# checks' in float64, and the JAX step's case in float32 on both meshes
JOB_CASES = {"1x2": [("base", 64), ("clip_remat", 64), (JAX_CASE, 32)],
             "2x2": [("clip_remat", 64), (JAX_CASE, 32)],
             "single": [("base", 64), ("clip_remat", 64)]}
MESH_CASES = [(m, c) for m in MESHES for c, bits in JOB_CASES[m] if bits == 64]


def _case(runs, mesh, name, bits=64):
    """The mesh's rank 0 result of a case, and the one process's (float64)."""
    _, _, ranks, single, _ = runs
    return (ranks[mesh][0]["cases"][JOB_CASES[mesh].index((name, bits))],
            single["cases"][JOB_CASES["single"].index((name, 64))])


def _flax_leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flax_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.fixture(scope="module")
def flagship():
    """The flagship's params trees (shapes only) and the port's G and D on
    the meta device."""
    cfg = dict(JAX_DEFAULT_CONFIG)
    shapes = jax.eval_shape(lambda k: jax_init(JaxG.from_config(cfg), JaxD.from_config(cfg),
                                               cfg, k), jax.random.PRNGKey(0))
    with torch.device("meta"):
        port = {"G": Generator.from_config(cfg), "D": Discriminator.from_config(cfg)}
    return {"G": shapes.params_G, "D": shapes.params_D}, port


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("net", ["G", "D"])
def test_param_split_matches_the_jax_rule(flagship, net, n_model):
    """Every leaf of the flagship's G and D: the port's split (style and
    axis, read off the flax path and shape) is the JAX sharding's, and the
    port's torch dim is the flax axis through the converter's layout."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    params, port = flagship
    mesh = jax_make_mesh(n_data=8 // n_model, n_model=n_model)
    specs = dict((tuple(k.key for k in p), s.spec) for p, s in jax.tree_util.tree_flatten_with_path(
        param_shardings(params[net], mesh, tensor_parallel=True))[0])
    shapes = dict(_flax_leaves(jax.tree_util.tree_map(lambda l: l.shape, params[net])))
    rule = split_rule(port[net], n_model)
    layout = _flax_param_layout(port[net])
    assert set(specs) == {path for path, _ in layout.values()}
    for name, (path, to_flax) in layout.items():
        spec, shape = specs[path], shapes[path]
        axes = [i - len(shape) for i, a in enumerate(spec) if a == "model"]
        split = param_split(path, shape, n_model)
        assert (None if split is None else [split[1]]) == (axes or None), (name, spec)
        assert (name in rule) == (split is not None), name
        if split is not None:
            # each rank's torch slice is its slice of the flax leaf along the JAX axis
            style, dim = rule[name]
            index = np.arange(np.prod(shape), dtype=np.int32).reshape(
                port[net].get_parameter(name).shape)
            assert style == split[0]
            for got, want in zip(np.split(index, n_model, axis=dim),
                                 np.split(to_flax(index), n_model, axis=split[1])):
                assert np.array_equal(to_flax(got), want), name


def test_flagship_counts_and_every_split_leaf_has_a_layer(flagship):
    """At ``model`` 2: G 112 column and 2 row leaves, D 44 and 3 (the
    issue's reading of the JAX rule); every split leaf is the weight of a
    split layer, and the pairs keep their activation split."""
    _, port = flagship
    mesh = Mesh(n_data=1, rank=0, n_model=2)
    want = {"G": (112, 2, {"RR_G.layers_0.linear2.weight",
                           "RR_G.layers_0.self_attn.o_proj.weight"}),
            "D": (44, 3, {"RR_D.layers_0.linear2.weight",
                          "RR_D.layers_0.self_attn.o_proj.weight", "attn_2.o.weight"})}
    for net, (n_col, n_row, rows) in want.items():
        rule = split_rule(port[net], 2)
        assert sum(s == "column" for s, _ in rule.values()) == n_col
        assert {n for n, (s, _) in rule.items() if s == "row"} == rows
        splits = tensor.layer_splits(port[net], rule, mesh)
        assert len(splits) == n_col + n_row
        paired = {n for n, s in splits.items() if s.paired}
        assert {n.rsplit(".", 1)[0] for n in rows} <= paired
        assert len(paired) == 2 * n_row
    assert "attn_2.theta.weight" not in split_rule(port["D"], 2)
    assert split_rule(port["D"], 2)["attn_2.g.weight"] == ("column", 0)
    assert split_rule(port["G"], 2)["shared.weight"] == ("column", 1)


def test_a_split_leaf_without_a_layer_raises():
    """A rule naming a leaf no split layer takes is refused, not replicated."""
    m = MultiheadSelfAttention(128, 2, Linear)
    mesh = Mesh(n_data=1, rank=0, n_model=2)
    with pytest.raises(ValueError, match="no split layer"):
        tensor.layer_splits(m, {"qkv_proj.bias": ("column", 0)}, mesh)
    with pytest.raises(ValueError, match="has no split layer"):
        tensor.layer_splits(m, {"qkv_proj.weight": ("row", 0)}, mesh)


def test_the_width_splits_every_kind_of_leaf():
    """``CONFIG`` at ``model`` 2 splits a column conv, the SA row convs,
    the RRMs' row linears, the shared embedding, conditional-BN linears, SN
    leaves and G leaves that take ortho-reg, so (b) cannot pass vacuously."""
    G, D = Generator.from_config(CONFIG), Discriminator.from_config(CONFIG)
    rule = {"G": split_rule(G, 2), "D": split_rule(D, 2)}
    modules = {net: dict(m.named_modules()) for net, m in (("G", G), ("D", D))}

    def count(net, pred):
        return sum(1 for n, s in rule[net].items() if pred(n, s, modules[net][n.rsplit(".", 1)[0]]))

    assert count("D", lambda n, s, m: s == ("column", 0) and isinstance(m, SNConv2d)) >= 5
    assert count("D", lambda n, s, m: s[0] == "row" and n.endswith(".o.weight")) == 3
    for net in ("G", "D"):
        assert count(net, lambda n, s, m: s[0] == "row" and "linear2" in n) == 1
        assert count(net, lambda n, s, m: s[0] == "row" and "o_proj" in n) == 1
    assert rule["G"]["shared.weight"] == ("column", 1)
    assert count("G", lambda n, s, m: ".bn" in n and isinstance(m, SNLinear)) >= 3
    assert count("D", lambda n, s, m: isinstance(m, SNEmbedding)) == 1
    # G's ortho-reg takes every split leaf but the shared embedding
    assert count("G", lambda n, s, m: not n.startswith("shared.")) >= 10


@pytest.mark.parametrize("mesh,name", MESH_CASES)
def test_tp_metrics_equal_one_process(runs, mesh, name):
    got, want = _case(runs, mesh, name)
    assert len(got["metrics"]) == len(want["metrics"]) == 2
    for g, w in zip(got["metrics"], want["metrics"]):
        assert set(g) == set(w) and len(w) == 6
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=TOL, atol=TOL, err_msg=k)


@pytest.mark.parametrize("net", ["G", "D"])
@pytest.mark.parametrize("mesh,name", MESH_CASES)
def test_tp_gradients_equal_one_process(runs, mesh, name, net):
    """The gradients each optimizer took in the first step (split leaves
    gathered whole), leaf for leaf."""
    got, want = _case(runs, mesh, name)
    errs = _leaf_errors(got["grads"][net], want["grads"][net])
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    assert len(errs) > 20 and max(errs.values()) < TOL, worst


def _check_state(got, want, initial, net):
    """``got``'s state (``state`` and ``moments`` by network) against
    ``want``'s after the first step: every buffer (``u``, ``sv``, BN stats)
    and, for G_ema, every tensor within 1e-5; every parameter of G and D
    within 1e-5, except the leaves with a null gradient, which moved by less
    than the learning rate on both sides; Adam's moments of the leaves with
    a real gradient within 1e-5 relative."""
    lr = CONFIG["G_lr" if net == "G_ema" else f"{net}_lr"]
    grads = {} if net == "G_ema" else want["grads"][net]
    for k, w in want["state"][net].items():
        g = got["state"][net][k]
        assert g.shape == w.shape, k
        if k in grads and float(grads[k].norm()) < 1e-5:
            assert float((g - initial[k]).abs().max()) < lr, k
            assert float((w - initial[k]).abs().max()) < lr, k
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


@pytest.mark.parametrize("net", ["G", "D", "G_ema"])
@pytest.mark.parametrize("mesh,name", MESH_CASES)
def test_tp_updated_state_equals_one_process(runs, mesh, name, net):
    """After the first step, gathered whole, within ``_check_state``'s
    bounds of the one process's."""
    got, want = _case(runs, mesh, name)
    _check_state(got, want, runs[4]["single"]["cases"][0][net], net)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_matches_jax_sharded_step(runs, mesh):
    """``clip_remat``'s metrics, gradients leaf for leaf, and the updates of
    G and D against the JAX package's tensor-parallel step on a 2x2 mesh,
    within ``tests/test_torch_parallel.py``'s bounds."""
    state, (new_state, jmets), *_ = runs
    got = _case(runs, mesh, JAX_CASE, 32)[0]
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


@pytest.mark.parametrize("net", ["G", "D"])
def test_clip_norm_clips(runs, net):
    """In ``clip_remat`` the global norm of the gradients (after ortho-reg)
    is above ``clip_norm``, so the clip acts on both networks' updates."""
    _, want = _case(runs, "2x2", "clip_remat")
    norm = float(torch.sqrt(sum(torch.sum(g.double() ** 2) for g in want["grads"][net].values())))
    assert norm > 2 * CASES["clip_remat"]["clip_norm"], norm


@pytest.mark.parametrize("mesh,name", MESH_CASES)
def test_replicas_bit_equal_and_shards_hold_a_share(runs, mesh, name):
    """After two steps every replicated leaf (parameters, buffers, Adam
    moments, counts) is bit-equal on every rank; a split leaf, its Adam
    moments and its G_ema twin hold 1/M of the whole on each rank, and the
    ranks of one model index hold the same shards."""
    _, _, ranks, single, _ = runs
    n_data, n_model = MESHES[mesh]
    results = [r["cases"][JOB_CASES[mesh].index((name, 64))] for r in ranks[mesh]]
    whole = single["cases"][JOB_CASES["single"].index((name, 64))]
    G, D = Generator.from_config(CONFIG), Discriminator.from_config(CONFIG)
    split = {f"{net}.{n}" for net, m in (("G", G), ("D", D), ("G_ema", G))
             for n in split_rule(m, n_model)}
    numels = {f"{net}.{n}": p.numel() for net, m in (("G", G), ("D", D), ("G_ema", G))
              for n, p in m.named_parameters()}
    n_split = 0
    for key, n in results[0]["numel"].items():
        leaf = key.removeprefix("opt_").rsplit(".", 1)[0] if key.startswith("opt_") else key
        if leaf in split:
            assert all(r["numel"][key] * n_model == numels[leaf] for r in results), key
            n_split += 1
        else:
            assert all(r["numel"][key] == numels[leaf] for r in results), key
    assert n_split == 3 * len(split) - 2 * len([k for k in split if k.startswith("G_ema.")])
    replicated = [k for k in whole["digest"] if _leaf_of(k) not in split]
    assert len(replicated) > 100
    for k in replicated:
        assert len({r["digest"][k] for r in results}) == 1, k
    for k in set(whole["digest"]) - set(replicated):
        for m in range(n_model):
            assert len({results[d * n_model + m]["digest"][k] for d in range(n_data)}) == 1, k
        assert len({r["digest"][k] for r in results[:n_model]}) == n_model, k


def _leaf_of(digest_key):
    """The parameter a state digest's key belongs to (``G.x.weight`` for
    ``opt_G.x.weight.mu`` too)."""
    if digest_key.startswith("opt_"):
        return digest_key[4:].rsplit(".", 1)[0]
    return digest_key


def test_heads_that_do_not_divide_the_model_axis(runs):
    """The RRM's attention, 2 heads at ``model`` 4: qkv is split by columns
    and gathered, every rank computes both heads, ``o_proj`` takes its
    rows; output and gradients within 1e-5 of one process."""
    job = runs[4]["attention"]
    m = MultiheadSelfAttention(job["dim"], job["heads"], Linear)
    m.load_state_dict(job["weights"])
    x = job["x"].clone().requires_grad_(True)
    out = m(x)
    torch.sum(out * job["w"]).backward()
    for r in runs[2]["2x2"]:
        got = r["attention"]
        assert got["splits"] == {"qkv_proj": ("column", False), "o_proj": ("row", False)}
        torch.testing.assert_close(got["out"], out.detach(), rtol=TOL, atol=TOL)
        torch.testing.assert_close(got["x_grad"], x.grad, rtol=TOL, atol=TOL)
        for n, p in m.named_parameters():
            torch.testing.assert_close(got["grads"][n], p.grad, rtol=TOL, atol=TOL)


def _files(path):
    return sorted(p.name for p in path.iterdir())


def _tree_shapes(tree):
    return {k: np.asarray(v).shape for k, v in _flax_leaves(tree)}


def test_tp_checkpoint_loads_in_one_process(runs):
    """The checkpoint rank 0 wrote under 1x2 after ``clip_remat``'s first
    step: the files one process writes, each with their keys and shapes
    (the clip's optimizer state too); loaded by one
    process, its state is the one process's after that step within
    ``_check_state``'s bounds."""
    jobs = runs[4]
    tp, one = jobs["dir"] / "tp12", jobs["dir"] / "one"
    assert _files(tp) == _files(one) and len(_files(tp)) == 6
    for name in _files(one):
        if name.endswith(".msgpack"):
            assert _tree_shapes(read_checkpoint(tp / name)) == _tree_shapes(
                read_checkpoint(one / name)), name
        else:
            assert json.loads((tp / name).read_text()) == json.loads((one / name).read_text())
    state = case_state(jobs["single"]["cases"][1], None)
    load_checkpoint(tp, state, "copy1")
    assert state.itr == 1
    got = {"state": {net: getattr(state, net).state_dict() for net in ("G", "D", "G_ema")},
           "moments": {net: {n: {m: getattr(state, f"opt_{net}").state[p][m]
                                 for m in ("mu", "nu")}
                             for n, p in getattr(state, net).named_parameters()}
                       for net in ("G", "D")}}
    _, want = _case(runs, "1x2", "clip_remat")
    for net in ("G", "D", "G_ema"):
        _check_state(got, want, jobs["single"]["cases"][0][net], net)


def test_one_process_checkpoint_loads_under_tp(runs):
    """A one-process checkpoint (random Adam moments, counts 5) loaded under
    1x2: each rank holds its shards (1/2 of every split leaf), its whole
    state is the file's bit for bit, and written back from 1x2 the files
    are the same bytes."""
    jobs = runs[4]
    want = case_state(jobs["single"]["cases"][0], None)
    load_checkpoint(jobs["dir"] / "one0", want, "copy5")
    G = Generator.from_config(CONFIG)
    split = {f"G.{n}" for n in split_rule(G, 2)}
    for r in runs[2]["1x2"]:
        got = r["checkpoint"]
        assert got["counts"] == (5, 5, 5)
        for net in ("G", "D", "G_ema"):
            for k, v in getattr(want, net).state_dict().items():
                assert torch.equal(got["state"][net][k], v), (net, k)
        for net in ("G", "D"):
            opt, module = getattr(want, f"opt_{net}"), getattr(want, net)
            for n, p in module.named_parameters():
                for m in ("mu", "nu"):
                    assert torch.equal(got["moments"][net][n][m], opt.state[p][m]), (n, m)
        halves = [k for k in got["numel"] if k in split]
        assert halves and all(got["numel"][k] * 2 == G.get_parameter(k[2:]).numel()
                              for k in halves)
    src, back = jobs["dir"] / "one0", jobs["dir"] / "resave12"
    assert _files(src) == _files(back)
    for name in _files(src):
        if name.endswith(".msgpack"):
            assert (src / name).read_bytes() == (back / name).read_bytes(), name


CLI_CONFIG = tiny_config(mesh="1x2", debug=True, debug_batches=2, num_epochs=1,
                         log_interval=1, sv_log_interval=2, save_every=1000, test_every=1000,
                         compute_dtype="float32", samples_per_class_sheet=0)


def _cli_launch(root, name, extra):
    """``train_torch.py --config <CLI_CONFIG + extra>`` started in two ranks
    as ``torchrun`` starts them (run ``tp`` under ``root``, each rank's
    output under ``root/name``); returns the processes."""
    root.mkdir(exist_ok=True)
    path = root / f"{name}.json"
    path.write_text(json.dumps(dict(CLI_CONFIG, **extra)))
    (root / name).mkdir()
    argv = ["--config", str(path), "--outputroot", str(root), "--run-name", "tp"]
    return start_processes(rank_targets(run_cli_rank, 2, (free_port(), argv, {},
                                                           str(root / name))))


def _cli_runs(root):
    """The CLI's first run (two steps and the final save), then its resume
    to step 3."""
    join_processes(_cli_launch(root, "first", {}))
    join_processes(_cli_launch(root, "resume", dict(resume=True, num_epochs=2, stop_after=3)))


def test_tp_driver_run(runs):
    """``train_torch.py --mesh 1x2`` in two ranks (gloo, debug batches):
    two steps and the final save, then a resume to step 3 (both run while
    ``runs`` is made). Rank 0 alone writes; the mesh line says ``tp=True``;
    the replicated leaves are bit-equal on both ranks and the split ones
    differ; the saved files hold the one-process shapes."""
    root, cfg = runs[4]["cli"], CLI_CONFIG
    logs, ranks = [], []
    for name in ("first", "resume"):
        logs.append([(root / name / f"rank{r}.log").read_text() for r in (0, 1)])
        ranks.append([torch.load(root / name / f"rank{r}.pt", weights_only=False)
                      for r in (0, 1)])
    assert "mesh: {'data': 1, 'model': 2} tp=True" in logs[0][0], logs[0][0][-2000:]
    assert "checkpoint copy2 saved" in logs[0][0] and "checkpoint" not in logs[0][1]
    assert "Resuming from checkpoint 'copy2'" in logs[1][0]
    G = Generator.from_config(cfg)
    split = {f"{net}.{n}" for net in ("G", "G_ema") for n in split_rule(G, 2)}
    split |= {f"D.{n}" for n in split_rule(Discriminator.from_config(cfg), 2)}
    for run, itr in zip(ranks, (2, 3)):
        a, b = (r["digest"] for r in run)
        assert a["itr"] == b["itr"] == itr and a["opt_D.counts"] == (itr, itr)
        assert run[0]["state_dict"] == run[1]["state_dict"]
        differ = {k for k in a if a[k] != b[k]}
        assert differ and {_leaf_of(k) for k in differ} <= split, sorted(differ)[:5]
    one = case_state(dict(config=cfg, **{net: m.state_dict() for net, m in (
        ("G", G), ("D", Discriminator.from_config(cfg)), ("G_ema", G))}), None)
    load_checkpoint(root / "tp" / "weights", one, "copy3")
    assert one.itr == 3
    assert len((root / "tp" / "logs" / "G_loss.log").read_text().splitlines()) == 3
