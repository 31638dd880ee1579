"""Physics-residual A/B harness: train recipe variants at 64 px and score
them on the residual observables (twin of ``scripts/physics_ab.py``;
reference protocol: Evaluation/eval_all.py:75-120, 7-ADU noise cut).

    python -m ieagan_torch.train.physics_ab NAME [--steps 2000] \\
        [--overrides '{...}'] [--grid arms.json] [--eval-events 400] \\
        [--root _local/ab64] [--train-root DIR] [--test-root DIR] \\
        [--train-events 1200] [--seed 0] [--out FILE]

Each arm trains through the port's driver (``train/driver.py::run``) with
the flagship config, ``BASE_OVERRIDES`` (64 px, evaluation and sampling off,
plain attention as the JAX harness sets it) and the arm's overrides, for
``--steps`` steps (``resume`` on, so a finished arm is re-scored); then its
newest checkpoint generates ``--eval-events`` events, scored against the
test split's first 400 (at most) by ``eval/physics.py``. One JSON line per
arm, printed and appended to ``--out`` (default ``<root>/physics_ab.jsonl``):
the GAN/real occupancy, mean charge and tail fraction, ``backend`` ``cuda``
or ``cpu``. Runs on the GPU unless ``IEAGAN_PLATFORM=cpu`` asks for the CPU.

The splits are PNG trees of 40 sensors of 58x64 (default ``<root>/train``
and ``<root>/test``); a missing one is refused with the command that mints
it (``scripts/make_synthetic_dataset.py``, as the JAX harness calls it).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# 64px regime: flagship knobs with only the geometry scaled down (the choice
# of the dynamics A/B, train/dynamics_compare.py) and the evaluation and
# sampling machinery off (no FID stats exist at this scale); a copy of
# scripts/physics_ab.py:54-58
BASE_OVERRIDES = dict(
    resolution=64, H_base=1,
    test_every=10 ** 9, sample_every=10 ** 9, sv_log_interval=10 ** 9,
    log_interval=50, num_workers=2, use_pallas_attention=False,
)
# the splits' shape and seeds (scripts/physics_ab.py:61-71, 190-191)
SPLIT_SHAPE = dict(sensors=40, height=58, width=64)
TEST_EVENTS, TEST_EVENT_SEED = 400, 9000


def check_split(split_dir: str, events: int, event_seed: int | None):
    """Refuse a split with fewer than ``events`` events, saying how to mint it."""
    probe = os.path.join(split_dir, "1.1.1")
    if os.path.isdir(probe) and len(os.listdir(probe)) >= events:
        return
    cmd = (f"python scripts/make_synthetic_dataset.py {split_dir} --events {events} "
           f"--sensors {SPLIT_SHAPE['sensors']} --height {SPLIT_SHAPE['height']} "
           f"--width {SPLIT_SHAPE['width']} --seed 0"
           + (f" --event-seed {event_seed}" if event_seed is not None else ""))
    raise SystemExit(f"split {split_dir} is missing or holds fewer than {events} events; "
                     f"mint it with: {cmd}")


def arm_config(name: str, overrides: dict, steps: int, train_root: str, root: str,
               train_events: int) -> dict:
    """The arm's driver config (``scripts/physics_ab.py:196-213``): one step
    takes ``events_per_batch`` events, so the epochs cover ``steps``."""
    from ieagan_torch.core.config import DEFAULT_CONFIG
    config = dict(DEFAULT_CONFIG)
    config.update(BASE_OVERRIDES)
    config.update(overrides)
    steps_per_epoch = max(1, train_events // int(config.get("events_per_batch", 1)))
    config.update(
        dataroot=train_root,
        outputroot=os.path.join(root, "runs"),
        run_name=name,
        num_epochs=max(1, math.ceil(steps / steps_per_epoch)),
        stop_after=steps,
        save_every=steps,  # run() writes the final checkpoint too
    )
    config["resume"] = True  # reuse the run dir when re-scoring a variant
    return config


def tail_fraction(s: dict) -> float:
    """Fraction of the above-threshold intensity mass above 60 ADU: the
    over-weighted tail of the residual (``scripts/physics_ab.py:234-241``)."""
    bins, hist = s["intensity_bins"], s["intensity_hist"]
    above = hist[2:]  # skip the [-1, 1) and [1, 7) bins
    centers = 0.5 * (bins[2:-1] + bins[3:])
    total = above.sum()
    return float(above[centers > 60].sum() / total) if total else 0.0


def run_arm(args, name: str, overrides: dict, steps: int, device) -> dict:
    from ieagan_torch.deploy.inference import Model
    from ieagan_torch.eval import physics
    from ieagan_torch.train.driver import run
    from ieagan_torch.utils.run_dirs import initialize_directories

    check_split(args.train_root, args.train_events, None)
    check_split(args.test_root, TEST_EVENTS, TEST_EVENT_SEED)
    config = arm_config(name, overrides, steps, args.train_root, args.root, args.train_events)
    os.makedirs(config["outputroot"], exist_ok=True)
    initialize_directories(config)
    t0 = time.time()
    run(config, device=device)
    train_s = time.time() - t0

    # score: generated against real observables at the 7-ADU protocol; the
    # train config carries every architecture key a lever may touch
    model = Model.restore(os.path.join(config["outputroot"], name, "weights"), config=config,
                          device=device)
    gan = physics.get_stats(physics.generate_event_stream(model.G, model.config, args.seed),
                            args.eval_events)
    real = physics.get_stats(physics.real_event_stream(args.test_root, args.seed),
                             min(TEST_EVENTS, args.eval_events))
    occ_g = float(gan["per_sensor_occupancy"].mean())
    occ_r = float(real["per_sensor_occupancy"].mean())
    chg_g = float(np.nanmean(gan["per_sensor_mean_charge"]))
    chg_r = float(np.nanmean(real["per_sensor_mean_charge"]))
    result = {
        "variant": name,
        "overrides": overrides,
        "steps": steps,
        "backend": device.type,
        "train_s": round(train_s, 1),
        "eval_events": args.eval_events,
        "occupancy_gan": occ_g, "occupancy_real": occ_r,
        "occupancy_ratio": occ_g / occ_r if occ_r else None,
        "mean_charge_gan": chg_g, "mean_charge_real": chg_r,
        "mean_charge_ratio": chg_g / chg_r if chg_r else None,
        "tail_frac_gan": tail_fraction(gan),
        "tail_frac_real": tail_fraction(real),
    }
    line = json.dumps(result)
    print(line, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a", encoding="utf-8") as fp:
        fp.write(line + "\n")
    return result


def main(argv=None) -> list:
    """Every arm in turn; an arm that fails is reported and the rest run.
    Returns the finished arms' results."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("name", nargs="?", default=None)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--overrides", default="{}",
                    help="JSON config overrides: the lever under test")
    ap.add_argument("--grid", default=None,
                    help='JSON file (or inline JSON) with a list of arms [{"name": ..., '
                         '"overrides": {...}, "steps": N}, ...]')
    ap.add_argument("--eval-events", type=int, default=400)
    ap.add_argument("--root", default=os.path.join(REPO, "_local", "ab64"))
    ap.add_argument("--train-root", default=None, help="default: <root>/train")
    ap.add_argument("--test-root", default=None, help="default: <root>/test")
    ap.add_argument("--train-events", type=int, default=1200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="JSONL of results (default: "
                                                "<root>/physics_ab.jsonl)")
    args = ap.parse_args(argv)
    args.train_root = args.train_root or os.path.join(args.root, "train")
    args.test_root = args.test_root or os.path.join(args.root, "test")
    args.out = args.out or os.path.join(args.root, "physics_ab.jsonl")

    from ieagan_torch.train.cli import tool_device
    device = tool_device()
    if args.grid:
        raw = open(args.grid).read() if os.path.exists(args.grid) else args.grid
        arms = json.loads(raw)
    else:
        if not args.name:
            ap.error("need a variant NAME (or --grid)")
        arms = [{"name": args.name, "overrides": json.loads(args.overrides),
                 "steps": args.steps}]
    results = []
    for arm in arms:
        print(f"=== arm {arm['name']} ===", flush=True)
        try:
            results.append(run_arm(args, arm["name"], arm.get("overrides", {}),
                                   int(arm.get("steps", args.steps)), device))
        except Exception:  # noqa: BLE001 — one broken arm must not stop the grid
            traceback.print_exc()
    return results


if __name__ == "__main__":
    main()
