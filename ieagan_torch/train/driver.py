"""Run driver: the training loop around the train step (twin of
``ieagan_tpu/train/driver.py``; reference: train.py:22-247).

``run(config, device)`` keeps the JAX driver's behaviour and on-disk layout:
run dir ``<outputroot>/<run_name>/{samples,weights,logs}``, seed, init or
resume (with the stale ``best_FID`` floor), loggers and metadata, the debug
path (synthetic batches made once on the device and cycled) or the dataset
path (threaded loader, uploads in its producer thread), the epoch loop with
``log_interval``, ``sv_log_interval``, ``save_every``, ``stop_after`` and a
final checkpoint, each checkpoint followed by a fixed-z sample grid, a
per-class sample sheet and the similarity heatmaps. ``trace_dir`` writes a
``torch.profiler`` Chrome trace of steps ``trace_start`` ..
``trace_start + trace_steps``.

Not ported yet (ROADMAP A8, A10): the FID test (``run`` refuses a run that
would reach ``test_every``, where the JAX driver evaluates FID; nothing is
skipped quietly) and the mesh path (``mesh`` raises). The JAX driver's
retries on ``RESOURCE_EXHAUSTED`` exist for a network-attached TPU and have
no twin.
"""

from __future__ import annotations

import copy
import json
import pathlib
import time

import numpy as np
import torch

from ieagan_torch.core.config import DEFAULT_CONFIG
from ieagan_torch.core.precision import get_policy
from ieagan_torch.models.discriminator import Discriminator
from ieagan_torch.models.generator import Generator
from ieagan_torch.ops.image_norm import denorm, device_event_transform
from ieagan_torch.train.step import init_train_state, make_train_step
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
        raise RuntimeError("no CUDA device: the port trains on the GPU unless asked for the "
                           "CPU (train_torch.py: IEAGAN_PLATFORM=cpu; run(config, device='cpu'))")
    return device


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


def run_test(*args, **kwargs):
    """The FID test and best-checkpoint bookkeeping of the JAX driver
    (``ieagan_tpu/train/driver.py:441``): not ported yet (ROADMAP A8)."""
    raise NotImplementedError("the FID test is not ported yet (ROADMAP A8): set test_every "
                              "past the run's last iteration")


def _last_itr(itr0: int, epoch0: int, config: dict, steps_per_epoch: int) -> int:
    """The iteration the loop will end at."""
    epochs = max(0, int(config["num_epochs"]) - epoch0)
    if epochs == 0 or steps_per_epoch == 0:
        return itr0
    stop_after = int(config.get("stop_after", 10 ** 9))
    return min(itr0 + epochs * steps_per_epoch, max(stop_after, itr0 + 1))


def run(config: dict, device="cuda"):
    """Train as the JAX driver does; returns ``(state, state_dict)``. The
    run dir must exist (``utils/run_dirs.py::initialize_directories``)."""
    config = dict(DEFAULT_CONFIG, **config)
    device = resolve_device(device)
    if config.get("mesh"):
        raise NotImplementedError("the mesh path (several GPUs) is not ported yet (ROADMAP A10)")
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
    print("init: device param init...", flush=True)
    state = init_train_state(G, D, config, rng, compute_dtype=policy.compute_dtype)
    print(f"Param count for G: {sum(p.numel() for p in G.parameters())}")
    print(f"Param count for D: {sum(p.numel() for p in D.parameters())}")
    print(f"device: {device}, compute dtype {policy.compute_dtype}, events/batch: {epb}")

    state_dict = {"itr": 0, "epoch": 0, "save_num": 0, "save_best_num": 0,
                  "best_FID": 999999.0}
    weights_dir = runpath / "weights"
    if config.get("resume"):
        tag = latest_checkpoint(weights_dir)
        if tag:
            print(f"Resuming from checkpoint '{tag}'")
            state, state_dict = load_checkpoint(weights_dir, state, tag,
                                                load_optim=bool(config.get("load_optim", True)))
            print(f"checkpoint '{tag}' loaded (itr {state_dict.get('itr')})", flush=True)
            if float(state_dict.get("best_FID", 0.0)) < 0:
                # self-heal checkpoints poisoned by an invalid (negative) FID
                print(f"resetting invalid best_FID {state_dict['best_FID']} from checkpoint")
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
                print(f"best_FID threshold floored {state_dict['best_FID']:.2f} -> "
                      f"{min(best_fids):.2f} (existing best tags)")
                state_dict["best_FID"] = min(best_fids)

    train_log = Logger(config)
    MetricsLogger(config)  # the JSONL stream the FID test appends to (ROADMAP A8)
    write_metadata(config, state_dict)

    use_device_transform = False
    if config.get("debug") or not config.get("dataroot"):
        print("debug/synthetic data path")
        steps_per_epoch = int(config.get("debug_batches", 8))
        # synthetic batches are made once on the device and cycled
        h, w = int(config["resolution"]), int(config["resolution"]) * int(config["H_base"])
        labels = torch.arange(es, device=device).repeat(max(1, epb))
        dbg_batches = [
            (torch.rand((es * max(1, epb), h, w, 1), device=device,
                        generator=torch.Generator(device=device).manual_seed(seed + i)) * 2 - 1,
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
                              events_per_batch=epb, raw_uint8=use_device_transform)
        # resume: continue the shuffle sequence at the resumed epoch
        loader.set_epoch(int(state_dict.get("epoch", 0)))
        loader.device = device  # uploads in the loader's producer thread
        loader_factory = lambda: loader
        steps_per_epoch = len(loader)

    itr = int(state.itr)
    last = _last_itr(itr, int(state_dict.get("epoch", 0)), config, steps_per_epoch)
    if last // int(config["test_every"]) > itr // int(config["test_every"]):
        run_test()
    train_step = make_train_step(G, D, config, steps_per_epoch)

    print("entering train loop", flush=True)
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
            if use_device_transform:
                x = device_event_transform(x, rng)
            if trace_dir and itr == trace_start:
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

            if itr % int(config["log_interval"]) == 0:
                now = time.time()
                metrics_host = {k: metrics[k] for k in sorted(metrics) if not k.startswith("_")}
                sec_per_itr = (now - t_last_log) / int(config["log_interval"])
                t_last_log = now
                print(f"itr {itr} ({now - t_start:.1f}s, {sec_per_itr:.3f}s/itr): " + ", ".join(
                    f"{k}={v:.4f}" for k, v in metrics_host.items()))
                train_log.log(itr, sec_per_itr=sec_per_itr, **metrics_host)

            if itr % int(config["sv_log_interval"]) == 0:
                svs = {**get_singular_values(state.G, "G"), **get_singular_values(state.D, "D")}
                if svs:
                    train_log.log(itr, **svs)

            if itr % int(config["save_every"]) == 0:
                save_and_sample(state, state_dict, config, runpath)

            if itr >= stop_after:
                break
        state_dict["epoch"] = epoch + 1
        if itr >= stop_after:
            break
    # final checkpoint
    save_and_sample(state, state_dict, config, runpath)
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
