"""The port's training entry point against the JAX package's.

One tiny debug run of each driver (the config of ``tests/test_driver.py``,
f32) gives the run-dir layout to compare, and the JAX run's ``copy3`` (with
its Adam moments) is resumed by both frameworks for one step from the same
draws. Bounds of that step are ``tests/test_torch_train_step.py``'s: metrics
rtol 2e-3 and atol 2e-5; gradients per leaf ||port - jax|| / ||jax|| max
< 1e-2 and median < 1e-3; the update each parameter took within 1e-2 of
JAX's, relative, where its gradient is not null in exact arithmetic; the
resumed moments after the step within the gradients' bound (mu and nu are
the gradient and an average of its square: nu's error is at most twice the
gradient's, plus its carried part, which both load bit for bit).
"""

import json
import os
import subprocess
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from PIL import Image

from ieagan_tpu.models import Discriminator as JaxD
from ieagan_tpu.models import Generator as JaxG
from ieagan_tpu.train import init_train_state as jax_init
from ieagan_tpu.train import make_train_step as jax_make_step
from ieagan_tpu.train.driver import run as jax_run
from ieagan_tpu.train.driver import save_event_grid as jax_save_event_grid
from ieagan_tpu.utils import initialize_directories as jax_initialize_directories
from ieagan_tpu.utils import load_checkpoint as jax_load
from ieagan_torch.eval import fid
from ieagan_torch.models.convert import (discriminator_state_from_flax, generator_state_from_flax,
                                         optimizer_state_to_flax)
from ieagan_torch.models.discriminator import Discriminator
from ieagan_torch.models.generator import Generator
from ieagan_torch.train.cli import build_parser, load_cli_config
from ieagan_torch.train.driver import run, save_event_grid
from ieagan_torch.train.step import init_train_state, make_train_step
from ieagan_torch.utils.checkpoint import load_checkpoint
from ieagan_torch.utils.run_dirs import initialize_directories
from tests.helpers import tiny_config
from tests.test_torch_eval import PooledExtractor, few_torch_threads  # noqa: F401 (autouse)
from tests.test_torch_losses import jax_draws
from tests.torch_ranks import free_port, run_cli_rank, spawn_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = dict(debug=True, debug_batches=3, num_epochs=1, log_interval=1, sv_log_interval=2,
           save_every=3, test_every=1000, compute_dtype="float32")
METRICS = ("D_loss_real", "D_loss_fake", "unif_loss_d", "iea_loss", "unif_loss_g", "G_loss")


def _files(run_dir):
    """Relative paths under a run dir, the timestamped config copy named
    by its suffix."""
    out = set()
    for root, _, names in os.walk(run_dir):
        for name in names:
            rel = os.path.relpath(os.path.join(root, name), run_dir)
            out.add("<stamp>_config.json" if rel.endswith("_config.json") and "/" not in rel
                    else rel)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("runs")
    jcfg = tiny_config(outputroot=str(root), run_name="jax", **RUN)
    jax_initialize_directories(jcfg)
    jax_run(jcfg)
    pcfg = tiny_config(outputroot=str(root), run_name="port", **RUN)
    initialize_directories(pcfg)
    state, sd = run(pcfg, device="cpu")
    return root, pcfg, state, sd


def test_run_dir_matches_jax(runs):
    root, cfg, state, sd = runs
    assert state.itr == 3 and sd["itr"] == 3 and sd["epoch"] == 1
    port, jax_files = _files(root / "port"), _files(root / "jax")
    assert port == jax_files
    assert {"weights/G_optim_copy3.msgpack", "samples/fixed_samples3.jpg",
            "logs/G_loss.log", "logs/metalog.txt", "logs/sec_per_itr.log",
            "logs/D_input_conv_sv.log"} <= port
    lines = (root / "port" / "logs" / "G_loss.log").read_text().splitlines()
    assert [ln.split(": ")[0] for ln in lines] == ["1", "2", "3"]
    sv = (root / "port" / "logs" / "G_linear_sv.log").read_text().splitlines()
    assert [ln.split(": ")[0] for ln in sv] == ["2"]
    saved = json.loads((root / "port" / "weights" / "state_dict_copy3.json").read_text())
    assert saved["itr"] == 3


def test_port_resumes_its_run(runs, tmp_path):
    """Resume with two epochs and ``stop_after`` 5: the loop continues at
    itr 4 in epoch 1, and the Adam counts continue from 3. The profiler hook
    traces steps 4 and 5 into a Chrome trace, with the port's spans."""
    root, cfg, *_ = runs
    import shutil
    shutil.copytree(root / "port", tmp_path / "port")
    state, sd = run(dict(cfg, outputroot=str(tmp_path), resume=True, num_epochs=2,
                         stop_after=5, trace_dir=str(tmp_path / "trace"), trace_start=4,
                         trace_steps=1), device="cpu")
    trace = json.loads((tmp_path / "trace" / "trace_itr4.json").read_text())
    assert any(e.get("name", "").startswith("aten::") for e in trace["traceEvents"])
    steps = [e for e in trace["traceEvents"] if e.get("name") == "ieagan.train.step"
             and e.get("cat") == "user_annotation"]
    assert len(steps) == 2
    assert state.itr == 5 and sd["itr"] == 5 and sd["epoch"] == 2
    assert (state.opt_G.count, state.opt_D.count, state.opt_G.sched_count) == (5, 5, 5)
    assert (tmp_path / "port" / "weights" / "G_optim_copy5.msgpack").exists()
    lines = (tmp_path / "port" / "logs" / "G_loss.log").read_text().splitlines()
    assert [ln.split(": ")[0] for ln in lines] == ["1", "2", "3", "4", "5"]


def test_resume_step_matches_jax(runs):
    """The JAX run's copy3 resumed by both frameworks, one step each."""
    root, cfg, *_ = runs
    cfg = dict(cfg, run_name="jax")
    weights = root / "jax" / "weights"
    es, epb = cfg["n_classes"], cfg["events_per_batch"]
    b = es * epb
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (b, 32, 32, 1)).astype(np.float32)
    y = np.tile(np.arange(es, dtype=np.int32), epb)
    z = [rng.standard_normal((b, cfg["dim_z"])).astype(np.float32) for _ in range(2)]
    rdof = [rng.standard_normal((b, 4)).astype(np.float32) for _ in range(2)]
    key = jax.random.PRNGKey(4)
    key1, _, _, kaug_d = jax.random.split(key, 4)
    _, _, _, kaug_g = jax.random.split(key1, 4)
    policy = cfg["diff_aug_policy"]
    schedule = [z[0], rdof[0], jax_draws(kaug_d, x.shape, policy),
                jax_draws(jax.random.fold_in(kaug_d, 7), x.shape, policy),
                z[1], rdof[1], jax_draws(kaug_g, x.shape, policy)]

    jG, jD = JaxG.from_config(cfg), JaxD.from_config(cfg)
    before, _ = jax_load(weights, jax_init(jG, jD, cfg, jax.random.PRNGKey(0)), "copy3")
    rdof_iter = iter(rdof)

    def interceptor(next_fun, args, kwargs, context):
        if context.module.name == "linear_f" and context.method_name == "__call__":
            args = (args[0].at[:, -4:].set(jnp.asarray(next(rdof_iter))),) + tuple(args[1:])
        return next_fun(*args, **kwargs)

    step = jax_make_step(jG, jD, cfg, z_schedule=z, capture_grads=True)
    with nn.intercept_methods(interceptor):
        after, jmets = jax.jit(step)(before, jnp.asarray(x), jnp.asarray(y), key)

    state = init_train_state(Generator.from_config(cfg), Discriminator.from_config(cfg), cfg,
                             torch.Generator().manual_seed(7))
    state, _ = load_checkpoint(weights, state, "copy3")
    assert (state.itr, state.opt_G.count, state.opt_D.sched_count) == (3, 3, 3)
    old = {net: {k: v.clone() for k, v in getattr(state, net).state_dict().items()}
           for net in ("G", "D")}
    tmets = make_train_step(state.G, state.D, cfg, draw_schedule=schedule, capture_grads=True)(
        state, torch.tensor(x), torch.tensor(y).long())

    for name in METRICS:
        np.testing.assert_allclose(tmets[name], float(jmets[name]), rtol=2e-3, atol=2e-5,
                                   err_msg=name)
    assert state.itr == int(after.itr) == 4
    for net, convert in (("G", generator_state_from_flax), ("D", discriminator_state_from_flax)):
        grads = convert({"params": jax.tree_util.tree_map(np.asarray, jmets[f"_grads_{net}"])})
        errs = {}
        for name, w in grads.items():
            if np.linalg.norm(w) >= 1e-5:
                g = tmets[f"_grads_{net}"][name].double().numpy()
                errs[name] = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert len(errs) > 20
        assert max(errs.values()) < 1e-2 and np.median(list(errs.values())) < 1e-3, net

        want = convert({"params": jax.tree_util.tree_map(
            np.asarray, getattr(after, f"params_{net}"))})
        was = convert({"params": jax.tree_util.tree_map(
            np.asarray, getattr(before, f"params_{net}"))})
        module = getattr(state, net)
        for name, p in module.named_parameters():
            np.testing.assert_array_equal(old[net][name].numpy(), was[name], err_msg=name)
            if name not in errs:
                continue
            got_step, want_step = p.detach().numpy() - was[name], want[name] - was[name]
            err = np.linalg.norm(got_step - want_step) / np.linalg.norm(want_step)
            assert err < 1e-2, (net, name, err)

        opt = getattr(state, f"opt_{net}")
        jopt = serialization.to_state_dict(getattr(after, f"opt_{net}"))
        mine = optimizer_state_to_flax(opt, module)
        assert int(mine["0"]["count"]) == int(jopt["0"]["count"]) == 4
        assert int(mine["1"]["count"]) == int(jopt["1"]["count"]) == 4
        for moment, bound in (("mu", 1e-2), ("nu", 2e-2)):
            m = convert({"params": mine["0"][moment]})
            j = convert({"params": jax.tree_util.tree_map(np.asarray, jopt["0"][moment])})
            for name in errs:
                err = np.linalg.norm(m[name] - j[name]) / np.linalg.norm(j[name])
                assert err < bound, (net, moment, name, err)


def test_save_event_grid_matches_jax(tmp_path):
    """The grid array, written losslessly (PNG) by the JAX function and
    returned by the port's, for 6 images of 32x20 (2 columns, 3 rows, rows
    cropped 3:-3)."""
    imgs = np.random.default_rng(0).uniform(-1, 1, (6, 32, 20, 1)).astype(np.float32)
    jax_save_event_grid(imgs, tmp_path / "jax.png")
    want = np.asarray(Image.open(tmp_path / "jax.png"))
    got = save_event_grid(torch.from_numpy(imgs), tmp_path / "port.png")
    assert got.shape == want.shape == (3 * 26, 2 * 20) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port.png")), want)


def test_unported_parts_raise(tmp_path):
    """A mesh wider than the processes launched, on the model axis or the
    data axis, is refused before any step. The meshes themselves train
    (``test_two_rank_driver_run``; a model axis,
    ``tests/test_torch_tensor_parallel.py``)."""
    cfg = tiny_config(outputroot=str(tmp_path), run_name="r", **dict(RUN, test_every=2))
    initialize_directories(cfg)
    with pytest.raises(ValueError, match="world of 1"):
        run(dict(cfg, mesh="2x2"), device="cpu")
    with pytest.raises(ValueError, match="world of 1"):
        run(dict(cfg, mesh="2"), device="cpu")
    assert not os.listdir(tmp_path / "r" / "weights")


FID_RUN = dict(fid_dataset_name="tinyfid", num_incep_images=8, fid_gen_chunks=1)


def _mint_stats(tmp_path, extractor, kid=False):
    """Reference stats of 4 random sparse PNGs under ``extractor``, into
    ``$IEAGAN_STATS_DIR``."""
    folder = tmp_path / "real"
    folder.mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        img = np.where(rng.random((26, 32)) < 0.1, rng.integers(7, 255, (26, 32)), 0)
        Image.fromarray(img.astype(np.uint8)).save(folder / f"{i}.png")
    fid.make_custom_stats("tinyfid", str(folder), extractor=extractor)
    if kid:
        fid.make_custom_kid_stats("tinyfid", str(folder), extractor=extractor)


def _fid_records(run_dir):
    path = run_dir / "logs" / "metric_log.jsonl"
    return [r for r in map(json.loads, path.read_text().splitlines()) if "FID" in r]


def test_fid_test_in_process(tmp_path, monkeypatch):
    """A tiny run that reaches ``test_every`` computes FID in process against
    the minted stats, logs it, tracks it in ``best_FID`` and writes best0.
    The extractor is a 16-d stand-in (a 2048-d sqrtm takes minutes under the
    test run's workers); the subprocess test below runs Inception."""
    monkeypatch.setenv("IEAGAN_STATS_DIR", str(tmp_path / "stats"))
    extractor = PooledExtractor()
    monkeypatch.setattr(fid, "default_extractor", lambda config, device: extractor)
    _mint_stats(tmp_path, extractor)
    cfg = tiny_config(outputroot=str(tmp_path), run_name="fid", fid_subprocess=False,
                      **dict(RUN, debug_batches=2, save_every=2, test_every=2), **FID_RUN)
    initialize_directories(cfg)
    state, sd = run(cfg, device="cpu")
    (rec,) = _fid_records(tmp_path / "fid")
    assert rec["itr"] == 2 and np.isfinite(rec["FID"]) and rec["FID"] >= 0
    assert sd["best_FID"] == rec["FID"] and sd["save_best_num"] == 1
    weights = tmp_path / "fid" / "weights"
    for comp in ("G", "D", "G_ema", "G_optim", "D_optim"):
        assert (weights / f"{comp}_best0.msgpack").exists()
    best = json.loads((weights / "state_dict_best0.json").read_text())
    assert best["best_FID"] == rec["FID"] and best["itr"] == 2
    assert json.loads((weights / "state_dict_copy2.json").read_text())["best_FID"] == rec["FID"]


def test_best_rotation_and_invalid_fid(tmp_path, monkeypatch):
    """FIDs 5, 3, -54.13, nan, 4, 1 at itrs 1-6: every one is logged; the
    negative and the non-finite one are never tracked; the improvements
    write best0, best1, then best0 again (``num_best_copies`` 2)."""
    scores = iter([5.0, 3.0, -54.13, float("nan"), 4.0, 1.0])
    monkeypatch.setattr(fid, "compute_fid_from_state", lambda state, config: next(scores))
    cfg = tiny_config(outputroot=str(tmp_path), run_name="rot", fid_subprocess=False,
                      **dict(RUN, debug_batches=6, save_every=1000, test_every=1))
    initialize_directories(cfg)
    _, sd = run(cfg, device="cpu")
    logged = [r["FID"] for r in _fid_records(tmp_path / "rot")]
    assert logged[:3] == [5.0, 3.0, -54.13] and np.isnan(logged[3]) and logged[4:] == [4.0, 1.0]
    assert sd["best_FID"] == 1.0 and sd["save_best_num"] == 1
    weights = tmp_path / "rot" / "weights"
    best = {n: json.loads((weights / f"state_dict_best{n}.json").read_text()) for n in (0, 1)}
    assert (best[0]["itr"], best[0]["best_FID"]) == (6, 1.0)
    assert (best[1]["itr"], best[1]["best_FID"]) == (2, 3.0)
    assert not (weights / "G_best2.msgpack").exists()


def test_fid_subprocess_reads_a_jax_run(runs, tmp_path, monkeypatch, capsys):
    """The port's driver resumes the JAX run's copy3 and reaches
    ``test_every`` at itr 4 without a copy4 on disk: the subprocess
    (``IEAGAN_PLATFORM=cpu``, since the run is on the CPU) evaluates the
    newest checkpoint, the JAX package's copy3, and prints one JSON line
    with FID, KID and physics, which the driver logs and tracks."""
    import shutil
    root, *_ = runs
    shutil.copytree(root / "jax", tmp_path / "jax")
    monkeypatch.setenv("IEAGAN_STATS_DIR", str(tmp_path / "stats"))
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the child's torch and BLAS threads
    _mint_stats(tmp_path, fid.FeatureExtractor(device="cpu"), kid=True)
    cfg = tiny_config(outputroot=str(tmp_path), run_name="jax", resume=True, fid_subprocess=True,
                      test_kid=True, test_physics_events=2,
                      **dict(RUN, num_epochs=2, stop_after=4, save_every=1000, test_every=4),
                      **FID_RUN)
    initialize_directories(cfg)
    _, sd = run(cfg, device="cpu")
    out = capsys.readouterr().out
    assert "FID eval (copy3)" in out, out[-2000:]
    (rec,) = _fid_records(tmp_path / "jax")
    assert rec["itr"] == 4 and np.isfinite(rec["FID"]) and sd["best_FID"] == rec["FID"]
    extras = [r for r in map(json.loads, (tmp_path / "jax" / "logs" / "metric_log.jsonl")
                             .read_text().splitlines()) if "KID" in r]
    assert len(extras) == 1 and {"KID_floor", "phys_occupancy", "phys_mean_charge"} <= set(
        extras[0])
    assert (tmp_path / "jax" / "physics_copy3_2ev.pickle").exists()
    assert (tmp_path / "jax" / "weights" / "G_ema_best0.msgpack").exists()
    assert not (tmp_path / "jax" / "fid_subprocess.pid").exists()


def _launch_two_ranks(tmp_path, cfg, name):
    """``train_torch.py --config <cfg>`` in two ranks as ``torchrun
    --nproc-per-node 2`` starts them (gloo on the CPU); returns each rank's
    output and its state's digest and bookkeeping."""
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(cfg))
    out = tmp_path / name
    out.mkdir()
    argv = ["--config", str(path), "--outputroot", str(tmp_path), "--run-name", "dp"]
    spawn_ranks(run_cli_rank, 2, (free_port(), argv,
                                  {"IEAGAN_STATS_DIR": os.environ["IEAGAN_STATS_DIR"]}, str(out)))
    return ([(out / f"rank{r}.log").read_text() for r in (0, 1)],
            [torch.load(out / f"rank{r}.pt", weights_only=False) for r in (0, 1)])


def test_two_rank_driver_run(tmp_path, monkeypatch):
    """The CLI under two ranks with ``--mesh 2``: three steps with a save
    and rank 0's in-process FID test at itr 2 and the final save at 3, then
    a resume to 4. Rank 0 alone writes the logs (one line a step), the
    metrics (one FID record) and the checkpoints; both ranks end every run
    with bit-equal states and rank 0's bookkeeping."""
    monkeypatch.setenv("IEAGAN_STATS_DIR", str(tmp_path / "stats"))
    _mint_stats(tmp_path, PooledExtractor())
    cfg = tiny_config(fid_subprocess=False, mesh="2", **dict(RUN, save_every=2, test_every=2),
                      **FID_RUN)
    logs, ranks = _launch_two_ranks(tmp_path, cfg, "first")
    run_dir = tmp_path / "dp"
    assert ranks[0]["digest"] == ranks[1]["digest"] and ranks[0]["digest"]["itr"] == 3
    assert ranks[0]["state_dict"] == ranks[1]["state_dict"]
    assert "mesh {'data': 2, 'model': 1} over 2 processes" in logs[0], logs[0][-2000:]
    assert "checkpoint copy2 saved" in logs[0] and "The FID score is" in logs[0]
    assert "checkpoint" not in logs[1] and "FID" not in logs[1], logs[1]
    (rec,) = _fid_records(run_dir)
    assert rec["itr"] == 2 and np.isfinite(rec["FID"])
    assert ranks[1]["state_dict"]["best_FID"] == rec["FID"]
    assert len((run_dir / "logs" / "G_loss.log").read_text().splitlines()) == 3
    weights = run_dir / "weights"
    for tag in ("copy2", "copy3", "best0"):
        assert (weights / f"D_optim_{tag}.msgpack").exists(), tag

    logs, ranks = _launch_two_ranks(tmp_path, dict(cfg, resume=True, num_epochs=2, stop_after=4),
                                    "resume")
    assert "Resuming from checkpoint 'copy3'" in logs[0]
    assert ranks[0]["digest"] == ranks[1]["digest"] and ranks[0]["digest"]["itr"] == 4
    assert ranks[0]["digest"]["opt_D.counts"] == (4, 4)
    assert len((run_dir / "logs" / "G_loss.log").read_text().splitlines()) == 4
    assert (weights / "G_ema_copy4.msgpack").exists()


def test_refuses_existing_run_dir(runs):
    root, cfg, *_ = runs
    with pytest.raises(RuntimeError):
        initialize_directories(dict(cfg, resume=False))


def test_cli_merge_precedence(tmp_path, monkeypatch):
    """defaults < JSON config < flags given; both flag spellings."""
    path = tmp_path / "c.json"
    path.write_text(json.dumps({"G_ch": 24, "seed": 111}))
    config = load_cli_config(["--config", str(path), "--outputroot", "x", "--run-name", "r",
                              "--seed", "222"])
    assert (config["G_ch"], config["seed"], config["D_ch"], config["run_name"]) == (24, 222, 32,
                                                                                   "r")
    for flag in ("--num_epochs", "--num-epochs"):
        assert vars(build_parser().parse_args([flag, "7"]))["num_epochs"] == 7
    args = vars(build_parser().parse_args(["--device_transform", "true",
                                           "--compute-dtype", "float32"]))
    assert args == {"device_transform": True, "compute_dtype": "float32"}
    monkeypatch.chdir(tmp_path)
    (tmp_path / "config.json").write_text(json.dumps({"G_ch": 16}))
    assert load_cli_config(["--outputroot", "x"])["G_ch"] == 16


def test_cli_runs_on_the_cpu_only_when_asked(tmp_path):
    """``train_torch.py`` with ``IEAGAN_PLATFORM=cpu`` trains two tiny steps;
    without it, on a machine with no CUDA device, it exits with an error
    and writes nothing."""
    cfg = tiny_config(**dict(RUN, debug_batches=2, save_every=1000))
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(cfg))
    cmd = [sys.executable, os.path.join(REPO, "train_torch.py"), "--config", str(path),
           "--outputroot", str(tmp_path), "--run-name", "cli"]
    env = {k: v for k, v in os.environ.items() if k != "IEAGAN_PLATFORM"}
    if not torch.cuda.is_available():
        refused = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
        assert refused.returncode != 0 and "CUDA" in refused.stderr
        assert not (tmp_path / "cli").exists()
    done = subprocess.run(cmd, env=dict(env, IEAGAN_PLATFORM="cpu"), capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    assert "itr 2" in done.stdout
    assert (tmp_path / "cli" / "weights" / "G_optim_copy2.msgpack").exists()
    again = subprocess.run(cmd, env=dict(env, IEAGAN_PLATFORM="cpu"), capture_output=True,
                           text=True, timeout=300)
    assert again.returncode != 0 and "already exists" in again.stderr
