"""Run driver: the training loop around the train step (twin of
``ieagan_tpu/train/driver.py``; reference: train.py:22-247).

``run(config, device)`` keeps the JAX driver's behaviour and on-disk layout:
run dir ``<outputroot>/<run_name>/{samples,weights,logs}``, seed, init or
resume (with the stale ``best_FID`` floor), loggers and metadata, the debug
path (synthetic batches made once on the device and cycled) or the dataset
path (threaded loader, uploads in its producer thread), the epoch loop with
``log_interval``, ``sv_log_interval``, ``save_every``, ``test_every``,
``stop_after`` and a final checkpoint, each checkpoint followed by a fixed-z
sample grid, a per-class sample sheet and the similarity heatmaps.
``trace_dir`` writes a ``torch.profiler`` Chrome trace of steps
``trace_start`` .. ``trace_start + trace_steps``, both ends included
(``trace_steps + 1`` steps), with the port's spans (``core/spans.py``).

The FID test (``run_test``) runs ``ieagan_torch.eval.fid_eval_once`` in a
subprocess on the checkpoint just saved (``fid_subprocess``, the default;
the child's memory is returned when it exits) or computes FID in process,
logs FID (and KID and physics extras) to the metrics stream, keeps invalid
FIDs out of ``best_FID``, and writes ``best<n>`` checkpoints rotating over
``num_best_copies``.

The mesh (the JAX driver's mesh path, ``ieagan_tpu/train/driver.py:
219-256``): with ``mesh`` set (``"N"``, ``"NxM"``, ``{"data": N, "model":
M}``), or under a launcher with several processes, one process per GPU
trains the sharded step (``parallel/sharding.py``) on its data index's rows
of every batch; rank 0's state is broadcast first, and rank 0 alone writes
logs, metadata, checkpoints and samples and runs the FID test while the
others wait. With a ``model`` axis (tensor parallelism) each rank holds its
shards of the split leaves; every rank gathers them whole before a
checkpoint, and rank 0 saves, samples and tests on that whole state. The
JAX driver's retries on ``RESOURCE_EXHAUSTED`` exist for a network-attached
TPU and have no twin.
"""

from __future__ import annotations

import copy
import gc
import json
import os
import pathlib
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from ieagan_torch.core.config import DEFAULT_CONFIG
from ieagan_torch.core.mesh import make_mesh, parse_mesh_spec
from ieagan_torch.core.precision import get_policy
from ieagan_torch.eval import fid as fid_eval
from ieagan_torch.models.discriminator import Discriminator
from ieagan_torch.models.generator import Generator
from ieagan_torch.ops.image_norm import denorm
from ieagan_torch.parallel import distributed
from ieagan_torch.parallel.sharding import full_state, make_sharded_train_step, place_state
from ieagan_torch.train.step import init_train_state
from ieagan_torch.utils.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from ieagan_torch.utils.logging import Logger, MetricsLogger
from ieagan_torch.utils.plot import plot_imgs, plot_sim_heatmap, save_gray, tile
from ieagan_torch.utils.run_dirs import write_metadata
from ieagan_torch.utils.sampling import accumulate_standing_stats, eval_mode, sample_sheet


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist (the port
    runs on the CPU only when asked to)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU unless asked for the CPU "
                           "(IEAGAN_PLATFORM=cpu, a tool's --cpu flag, or run(config, "
                           "device='cpu'))")
    return device


def build_mesh(config: dict):
    """The run's mesh, or None for one process: the ``mesh`` key
    (``{"data": N, "model": M}``, ``"NxM"``, ``"N"``, ...), else every
    process of a launch with several on the data axis (the JAX driver's
    auto-mesh). The events of a batch must divide over the data axis."""
    epb = int(config.get("events_per_batch", 1))
    world = distributed.world_size()
    if config.get("mesh"):
        n_data, n_model = parse_mesh_spec(config["mesh"])
        mesh = make_mesh(n_data, n_model)
    elif world > 1:
        mesh = make_mesh(world)
    else:
        return None
    if epb % mesh.n_data:
        raise ValueError(f"events_per_batch={epb} must divide over the mesh data axis "
                         f"({mesh.n_data})")
    return mesh


def get_singular_values(module: torch.nn.Module, prefix: str) -> dict:
    """The first logged singular value of every spectral-norm layer, named as
    the JAX driver names them (``G_blocks_0_0_conv1_sv``; reference:
    utils/__init__.py:572-588), fetched from the device in one copy."""
    names, leaves = [], []
    for name, buf in module.named_buffers():
        if name.rsplit(".", 1)[-1] == "sv":
            names.append(f"{prefix}_" + name.replace(".", "_"))
            leaves.append(buf.reshape(-1)[:1])
    if not names:
        return {}
    vals = torch.cat(leaves).float().cpu().numpy()
    return dict(zip(names, vals.astype(float)))


def save_event_grid(imgs, path) -> np.ndarray:
    """Save a grid of the (B, H, W, 1) batch in ADU space (rows cropped,
    truncated to uint8, ``int(sqrt(B))`` columns); returns the grid."""
    adu = denorm(torch.as_tensor(imgs).float())[..., 0].cpu().numpy()  # (B, H-6, W)
    grid = tile(adu, max(1, int(np.sqrt(adu.shape[0]))))
    save_gray(grid, path)
    return grid


def run_test(state, state_dict: dict, config: dict, metrics_log):
    """The FID test and best-checkpoint bookkeeping (twin of
    ``ieagan_tpu/train/driver.py:441-520``; reference: train_fns.py:209-233).
    A non-finite or negative FID is logged but never tracked: the Fréchet
    distance is non-negative, and such a value would beat every real score
    for the rest of the run."""
    itr = int(state_dict["itr"])
    if bool(config.get("fid_subprocess", True)):
        res = _run_fid_subprocess(state, state_dict, config)
        if res is None:
            return
        fid = float(res["fid"])
        extras = {}
        if "kid" in res:
            extras["KID"] = float(res["kid"])
            if "kid_floor" in res:  # the real-vs-real floor, always shown beside it
                extras["KID_floor"] = float(res["kid_floor"])
            print(f"The KID score is {res['kid']}" + (
                f" (real-vs-real floor {res['kid_floor']})" if "kid_floor" in res else ""))
        if "physics" in res:
            p = res["physics"]
            extras["phys_occupancy"] = p["mean_occupancy"]
            extras["phys_mean_charge"] = p["mean_charge"]
            print(f"physics @{p['n_events']}ev: occupancy={p['mean_occupancy']:.5f} "
                  f"mean_charge={p['mean_charge']:.2f} -> {p['pickle']}")
        if extras:
            metrics_log.log(itr=itr, **extras)
    else:
        try:
            fid = fid_eval.compute_fid_from_state(state, config)
        except FileNotFoundError as e:
            print(f"FID reference stats unavailable ({e}); skipping test")
            return
        finally:
            if bool(config.get("fid_free_device_cache", True)):
                gc.collect()
                if torch.cuda.is_available():
                    torch.cuda.empty_cache()
    print(f"The FID score is {fid}")
    if not np.isfinite(fid) or fid < 0:
        print(f"FID {fid} is invalid (Fréchet >= 0); excluded from best-checkpoint tracking")
        metrics_log.log(itr=itr, FID=float(fid))
        return
    if config.get("which_best", "FID") == "FID" and fid < state_dict["best_FID"]:
        # best<n> with num_best_copies rotation (reference: train_fns.py:222-231)
        n = state_dict.get("save_best_num", 0)
        print(f"rotating best{n} checkpoint (FID {fid:.2f} < {state_dict['best_FID']:.2f})",
              flush=True)
        save_checkpoint(pathlib.Path(config["outputroot"]) / config["run_name"] / "weights",
                        state, dict(state_dict, best_FID=float(fid)), f"best{n}")
        state_dict["save_best_num"] = (n + 1) % int(config.get("num_best_copies", 2))
    state_dict["best_FID"] = min(state_dict["best_FID"], fid)
    metrics_log.log(itr=itr, FID=float(fid))


def _run_fid_subprocess(state, state_dict: dict, config: dict):
    """Run ``python -m ieagan_torch.eval.fid_eval_once`` on the checkpoint of
    this itr (else the newest); returns its JSON result, or None when there
    is no checkpoint or the evaluation failed or timed out. The child runs
    on the run's device type. While it runs, a line every 60 s tells a
    watchdog reading the log that the run is alive, and a SIGTERM to this
    process kills the child first."""
    runpath = pathlib.Path(config["outputroot"]) / config["run_name"]
    itr = int(state_dict.get("itr", state.itr))
    tag = f"copy{itr}"
    if not (runpath / "weights" / f"G_ema_{tag}.msgpack").exists():
        tag = latest_checkpoint(runpath / "weights")
        if tag is None:
            print("FID subprocess: no checkpoint to evaluate; skipping")
            return None
    repo = str(pathlib.Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p))
    if next(state.G.parameters()).device.type == "cpu":
        env["IEAGAN_PLATFORM"] = "cpu"
    cmd = [sys.executable, "-m", "ieagan_torch.eval.fid_eval_once", "--run-dir", str(runpath),
           "--tag", tag]
    if bool(config.get("test_kid", False)):
        cmd.append("--kid")
    n_phys = int(config.get("test_physics_events", 0))
    if n_phys > 0:
        cmd += ["--physics-events", str(n_phys)]
    timeout = float(config.get("fid_subprocess_timeout", 3600))
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    # the pid file leaves a trace for whoever borrows the card if this
    # process is killed without a chance to kill the child
    pidfile = runpath / "fid_subprocess.pid"
    try:
        pidfile.write_text(str(proc.pid))
    except OSError:
        pass

    def _term(signum, frame):
        proc.kill()
        raise SystemExit(128 + signum)

    main_thread = threading.current_thread() is threading.main_thread()
    prev_term = signal.signal(signal.SIGTERM, _term) if main_thread else None
    t0 = time.time()
    try:
        while True:
            try:
                stdout, stderr = proc.communicate(timeout=60.0)
                break
            except subprocess.TimeoutExpired:
                if time.time() - t0 > timeout:
                    proc.kill()
                    proc.communicate()
                    print("FID subprocess timed out; skipping test", flush=True)
                    return None
                print(f"FID subprocess running ({time.time() - t0:.0f}s)...", flush=True)
    finally:
        if main_thread:
            signal.signal(signal.SIGTERM, prev_term)
        pidfile.unlink(missing_ok=True)
    if proc.returncode != 0:
        print(f"FID subprocess failed rc={proc.returncode}: {stderr[-800:]}", flush=True)
        return None
    try:
        res = json.loads(stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        print(f"FID subprocess output unparsable: {stdout[-400:]}", flush=True)
        return None
    print(f"FID eval ({res['tag']}): nonzero_frac={res.get('nonzero_frac', -1):.5f}")
    return res


def run(config: dict, device="cuda"):
    """Train as the JAX driver does; returns ``(state, state_dict)``. The
    run dir must exist (``utils/run_dirs.py::initialize_directories``)."""
    config = dict(DEFAULT_CONFIG, **config)
    device = resolve_device(device)
    mesh = build_mesh(config)
    # the data axis: this rank's rows, its events and its share of the loader
    n_ranks, rank = (1, 0) if mesh is None else (mesh.n_data, mesh.data_index)
    is_main = distributed.rank() == 0
    say = print if is_main else (lambda *args, **kwargs: None)
    seed = int(config["seed"])
    np.random.seed(seed)
    torch.manual_seed(seed)
    rng = torch.Generator(device=device).manual_seed(seed)
    es = int(config["n_classes"])
    epb = int(config.get("events_per_batch", 1))
    runpath = pathlib.Path(config["outputroot"]) / config["run_name"]

    policy = get_policy(config.get("compute_dtype", "bfloat16"))
    with torch.device(device):
        G, D = Generator.from_config(config), Discriminator.from_config(config)
    say("init: device param init...", flush=True)
    state = init_train_state(G, D, config, rng, compute_dtype=policy.compute_dtype)
    say(f"Param count for G: {sum(p.numel() for p in G.parameters())}")
    say(f"Param count for D: {sum(p.numel() for p in D.parameters())}")
    say(f"device: {device}, compute dtype {policy.compute_dtype}, events/batch: {epb}"
        + ("" if mesh is None else f", mesh {mesh.shape} over "
           f"{mesh.n_data * mesh.n_model} processes "
           f"({distributed.backend() or 'no process group'})"))
    if mesh is not None:
        say(f"mesh: {mesh.shape} tp={mesh.n_model > 1}")

    state_dict = {"itr": 0, "epoch": 0, "save_num": 0, "save_best_num": 0,
                  "best_FID": 999999.0}
    weights_dir = runpath / "weights"
    if config.get("resume"):
        tag = latest_checkpoint(weights_dir)
        if tag:
            say(f"Resuming from checkpoint '{tag}'")
            state, state_dict = load_checkpoint(weights_dir, state, tag,
                                                load_optim=bool(config.get("load_optim", True)))
            say(f"checkpoint '{tag}' loaded (itr {state_dict.get('itr')})", flush=True)
            if float(state_dict.get("best_FID", 0.0)) < 0:
                # self-heal checkpoints poisoned by an invalid (negative) FID
                say(f"resetting invalid best_FID {state_dict['best_FID']} from checkpoint")
                state_dict["best_FID"] = 999999.0
            # A copy<N> written before that itr's eval carries a stale
            # best_FID threshold; the best tags' own state_dicts record their
            # genuine FIDs, so the rotation threshold is floored to their
            # minimum (ieagan_tpu/train/driver.py:141-163).
            best_fids = []
            for p in weights_dir.glob("state_dict_best*.json"):
                try:
                    v = float(json.loads(p.read_text()).get("best_FID", float("inf")))
                except (ValueError, OSError):
                    continue
                if v > 0:
                    best_fids.append(v)
            if best_fids and min(best_fids) < float(state_dict["best_FID"]):
                say(f"best_FID threshold floored {state_dict['best_FID']:.2f} -> "
                    f"{min(best_fids):.2f} (existing best tags)")
                state_dict["best_FID"] = min(best_fids)

    # every rank steps from rank 0's state (a resume loaded on each, or the
    # same-seed init)
    state = place_state(state, mesh)
    # log sinks and run files: rank 0 alone
    train_log = Logger(config) if is_main else None
    metrics_log = MetricsLogger(config) if is_main else None
    if is_main:
        write_metadata(config, state_dict)

    def on_main(fn, *args):
        """``fn`` on rank 0, on the whole state, while the others wait; then
        every rank takes rank 0's bookkeeping (save and best-FID counters)."""
        with full_state(state, mesh):
            if is_main:
                fn(*args)
            state_dict.update(distributed.broadcast_object(state_dict))

    use_device_transform = False
    epb_local = max(1, epb) // n_ranks
    if config.get("debug") or not config.get("dataroot"):
        say("debug/synthetic data path")
        steps_per_epoch = int(config.get("debug_batches", 8))
        # synthetic batches are made once on the device and cycled; each rank
        # makes its own events (seed + i + 1000 * rank, as the JAX driver)
        h, w = int(config["resolution"]), int(config["resolution"]) * int(config["H_base"])
        labels = torch.arange(es, device=device).repeat(epb_local)
        dbg_batches = [
            (torch.rand((es * epb_local, h, w, 1), device=device,
                        generator=torch.Generator(device=device).manual_seed(
                            seed + i + 1000 * rank)) * 2 - 1,
             labels)
            for i in range(min(steps_per_epoch, 4))]

        def loader_factory():
            for i in range(steps_per_epoch):
                yield dbg_batches[i % len(dbg_batches)]
    else:
        from ieagan_torch.data import load_dataset
        use_device_transform = bool(config.get("device_transform", False))
        loader = load_dataset(config["dataroot"], num_workers=int(config["num_workers"]),
                              shuffle=bool(config["shuffle"]), seed=seed,
                              events_per_batch=epb, raw_uint8=use_device_transform,
                              process_index=rank, process_count=n_ranks)
        # resume: continue the shuffle sequence at the resumed epoch
        loader.set_epoch(int(state_dict.get("epoch", 0)))
        loader.device = device  # uploads in the loader's producer thread
        loader_factory = lambda: loader
        steps_per_epoch = len(loader)

    itr = int(state.itr)
    # one step for one process or many: with the uint8 transform it runs
    # inside, its noise drawn for the global batch
    train_step = make_sharded_train_step(G, D, config, mesh, steps_per_epoch=steps_per_epoch,
                                         device_transform=use_device_transform)

    say("entering train loop", flush=True)
    t_start = time.time()
    t_last_log = t_start
    stop_after = int(config.get("stop_after", 10 ** 9))
    trace_dir = config.get("trace_dir")
    trace_start = int(config.get("trace_start", 10))
    trace_steps = int(config.get("trace_steps", 5))
    profiler = None
    for epoch in range(state_dict.get("epoch", 0), int(config["num_epochs"])):
        for x, y in loader_factory():
            itr += 1
            state_dict["itr"] = itr
            if trace_dir and is_main and itr == trace_start:
                activities = [torch.profiler.ProfilerActivity.CPU]
                if device.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                profiler = torch.profiler.profile(activities=activities)
                profiler.start()
            metrics = train_step(state, x, y, rng)
            if profiler is not None and itr >= trace_start + trace_steps:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                profiler.stop()
                pathlib.Path(trace_dir).mkdir(parents=True, exist_ok=True)
                trace = pathlib.Path(trace_dir) / f"trace_itr{trace_start}.json"
                profiler.export_chrome_trace(str(trace))
                profiler = None
                print(f"profiler trace written to {trace}")

            if is_main and itr % int(config["log_interval"]) == 0:
                now = time.time()
                metrics_host = {k: metrics[k] for k in sorted(metrics) if not k.startswith("_")}
                sec_per_itr = (now - t_last_log) / int(config["log_interval"])
                t_last_log = now
                print(f"itr {itr} ({now - t_start:.1f}s, {sec_per_itr:.3f}s/itr): " + ", ".join(
                    f"{k}={v:.4f}" for k, v in metrics_host.items()))
                train_log.log(itr, sec_per_itr=sec_per_itr, **metrics_host)

            if is_main and itr % int(config["sv_log_interval"]) == 0:
                svs = {**get_singular_values(state.G, "G"), **get_singular_values(state.D, "D")}
                if svs:
                    train_log.log(itr, **svs)

            if itr % int(config["save_every"]) == 0:
                on_main(save_and_sample, state, state_dict, config, runpath)

            if itr % int(config["test_every"]) == 0:
                on_main(run_test, state, state_dict, config, metrics_log)

            if itr >= stop_after:
                break
        state_dict["epoch"] = epoch + 1
        if itr >= stop_after:
            break
    # final checkpoint
    on_main(save_and_sample, state, state_dict, config, runpath)
    return state, state_dict


def save_and_sample(state, state_dict: dict, config: dict, runpath):
    """Checkpoint, then a fixed-z sample grid, a per-class sample sheet and
    the similarity heatmaps from the (EMA) generator (reference:
    utils/__init__.py:299-365, train.py:196-229)."""
    runpath = pathlib.Path(runpath)
    itr = state_dict["itr"]
    t0 = time.time()
    save_checkpoint(runpath / "weights", state, state_dict, f"copy{itr}")
    print(f"checkpoint copy{itr} saved in {time.time() - t0:.2f} s", flush=True)
    if int(config.get("num_save_copies", 2)) > 0:
        state_dict["save_num"] = (state_dict.get("save_num", 0) + 1) % int(
            config["num_save_copies"])
    use_ema = bool(config.get("ema")) and bool(config.get("use_ema"))
    G = state.G_ema if use_ema else state.G
    device = next(G.parameters()).device
    es, dtype = int(config["n_classes"]), state.compute_dtype
    if config.get("accumulate_stats"):
        G = accumulate_standing_stats(
            copy.deepcopy(G), config, torch.Generator(device=device).manual_seed(itr),
            int(config.get("num_standing_accumulations", 16)), dtype=dtype)
    z = torch.randn((es, int(config["dim_z"])), device=device,
                    generator=torch.Generator(device=device).manual_seed(int(config["seed"])))
    rdof = torch.randn((es, int(config["rdof_dim"])), device=device,
                       generator=torch.Generator(device=device).manual_seed(0))
    with torch.no_grad(), eval_mode(G):
        imgs = G(z.to(dtype), torch.arange(es, device=device), rdof).float()
    save_event_grid(imgs, runpath / "samples" / f"fixed_samples{itr}.jpg")
    per_class = int(config.get("samples_per_class_sheet", 4))
    if per_class > 0:
        sheets = sample_sheet(G, config, torch.Generator(device=device).manual_seed(itr),
                              samples_per_class=per_class, dtype=dtype)
        plot_imgs(sheets.reshape(-1, *sheets.shape[2:]),
                  runpath / "samples" / f"sample_sheet{itr}.jpg", ncol=sheets.shape[1])
    try:
        plot_sim_heatmap(G.shared.weight.detach().float().cpu().numpy(),
                         runpath / "samples" / f"sim_heatmap_G{itr}.jpg",
                         title=f"G shared-embedding similarity @ {itr}")
        plot_sim_heatmap(state.D.embed.weight.detach().float().cpu().numpy(),
                         runpath / "samples" / f"sim_heatmap_D{itr}.jpg",
                         title=f"D class-proxy similarity @ {itr}")
    except Exception as e:  # noqa: BLE001 — plotting must never kill training
        print(f"sim-heatmap plotting failed: {e}")
