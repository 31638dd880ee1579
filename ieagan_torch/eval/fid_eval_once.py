"""One FID evaluation of a saved checkpoint, in its own process (twin of
``scripts/fid_eval_once.py``).

    python -m ieagan_torch.eval.fid_eval_once --run-dir <out>/<run> --tag copy2000 \
        [--num-gen N] [--kid] [--physics-events N]

The training driver runs it as a subprocess by default (``fid_subprocess``):
the evaluation's memory is returned when the process exits. It reads the
run's newest ``*_config.json`` and the generator (``G_ema`` when the run uses
EMA, else ``G``) of ``weights/<base>_<tag>.msgpack``: run dirs of the port
and of the JAX package alike, since both write the same files. The
generator computes in the run's ``compute_dtype``. It runs on the GPU unless
``IEAGAN_PLATFORM=cpu`` asks for the CPU, as ``train_torch.py`` does, and
reads reference statistics from ``$IEAGAN_STATS_DIR`` (default ``stats/``).

Prints exactly one JSON line on stdout:
``{"fid": ..., "nonzero_frac": ..., "tag": ...}``, plus ``kid`` and
``kid_floor`` under ``--kid`` (when the ``_kid.npz`` features exist) and a
``physics`` summary under ``--physics-events`` (its full stats pickled in
the run dir). ``nonzero_frac`` is the share of generated pixels at 0.5 ADU
or more in one generated block: whether G has left the black basin.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import pickle
import sys

import numpy as np
import torch


def load_run_generator(run_dir: str, tag: str, device):
    """``(G, config)`` of a run dir of either package's driver: the newest
    ``*_config.json`` over the defaults, and ``weights/<base>_<tag>.msgpack``
    with ``base`` ``G_ema`` when the run keeps and uses EMA, else ``G``
    (``scripts/kid_eval.py:62-63``), on ``device`` in eval mode."""
    from ieagan_torch.core.config import DEFAULT_CONFIG
    from ieagan_torch.models.convert import generator_state_from_flax
    from ieagan_torch.models.generator import Generator
    from ieagan_torch.utils.flax_msgpack import read_checkpoint

    cfgs = sorted(glob.glob(os.path.join(run_dir, "*_config.json")))
    if not cfgs:
        raise SystemExit(f"no *_config.json under {run_dir}")
    with open(cfgs[-1], encoding="utf-8") as fp:
        config = dict(DEFAULT_CONFIG, **json.load(fp))
    use_ema = bool(config.get("ema")) and bool(config.get("use_ema"))
    path = os.path.join(run_dir, "weights", f"{'G_ema' if use_ema else 'G'}_{tag}.msgpack")
    with torch.device(device):
        G = Generator.from_config(config)
    state = generator_state_from_flax(read_checkpoint(path), G.state_dict())
    G.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in state.items()}, strict=True)
    return G.eval().requires_grad_(False), config


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run-dir", required=True)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--num-gen", type=int, default=None)
    ap.add_argument("--kid", action="store_true",
                    help="also compute KID from the same generated features (needs "
                         "<dataset>_<mode>_custom_na_kid.npz)")
    ap.add_argument("--physics-events", type=int, default=0,
                    help="also accumulate physics stats over N generated events, pickled in "
                         "the run dir")
    args = ap.parse_args(argv)

    from ieagan_torch.core.precision import get_policy
    from ieagan_torch.eval import fid as fid_mod
    from ieagan_torch.eval import physics
    from ieagan_torch.ops.image_norm import denorm
    from ieagan_torch.train.cli import tool_device

    device = tool_device()
    G, config = load_run_generator(args.run_dir, args.tag, device)
    if args.num_gen:
        config["num_incep_images"] = args.num_gen
    dtype = get_policy(config.get("compute_dtype", "bfloat16")).compute_dtype

    trunc = float(config.get("fid_trunc", 1.0))
    gen = fid_mod.make_generator_fn(G, config, trunc=trunc if trunc > 0 else None,
                                    chunks=int(config.get("fid_gen_chunks", 8)), dtype=dtype)
    sample = gen(torch.Generator(device=device).manual_seed(1234))
    out = {"nonzero_frac": float((denorm(sample) >= 0.5).float().mean()), "tag": args.tag}
    if args.kid:
        # one feature pass serves both metrics: FID from the features' f64
        # moments, KID from the features against the stored real features
        fid, feats = fid_mod.compute_fid_with(G, config, dtype, return_features=True)
        mode = config.get("fid_mode", "clean")
        kid_path = fid_mod._stats_path(config.get("fid_dataset_name", "pxd_sim_test_com"),
                                       mode).replace(".npz", "_kid.npz")
        if os.path.exists(kid_path):
            ref_feats = np.load(kid_path)["feats"]
            seed = int(config.get("seed", 0))
            out["kid"] = float(fid_mod.kernel_distance(feats, ref_feats, seed=seed))
            out["kid_floor"] = float(fid_mod.kid_self_floor(ref_feats, seed=seed))
        else:
            print(f"# KID stats {kid_path} missing; skipping KID", file=sys.stderr)
    else:
        fid = fid_mod.compute_fid_with(G, config, dtype)
    out["fid"] = float(fid)
    if args.physics_events > 0:
        stats = physics.get_stats(
            physics.generate_event_stream(G, config, seed=int(config.get("seed", 0)),
                                          dtype=dtype),
            n_events=args.physics_events)
        ppath = os.path.join(args.run_dir, f"physics_{args.tag}_{args.physics_events}ev.pickle")
        with open(ppath, "wb") as fp:
            pickle.dump(stats, fp)
        out["physics"] = {
            "n_events": int(stats["n_events"]),
            "mean_occupancy": float(np.mean(stats["per_sensor_occupancy"])),
            "mean_charge": float(np.nanmean(stats["per_sensor_mean_charge"])),
            "pickle": ppath,
        }
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
