"""Best-checkpoint proof metrics: FID and KID from one generation pass
(twin of ``scripts/kid_eval.py``; reference: mycleanfid/fid.py:476-487).

    python -m ieagan_torch.eval.kid_eval --run-dir <out>/<run> --tag best0 \\
        [--num 16000] [--cpu]

Loads the run's generator as ``eval/fid_eval_once.py`` does (newest
``*_config.json``; ``G_ema`` when the run keeps and uses EMA, else ``G``),
computing in bfloat16 whatever the run's ``compute_dtype``, as the JAX script
builds it. Generates ``--num`` images (trunc-trick z at ``fid_trunc``, <= 0
none; ``fid_gen_chunks`` batches per call; seeded from the run's ``seed``),
takes their Inception features once, and prints one JSON line:
``{"tag", "num", "fid", "kid_x1e3", "kid_floor_x1e3", "dataset"}``: FID from
the features' host f64 moments against the minted dataset stats, KID against
the minted raw features, and KID's real-vs-real floor, both times 1e3. Runs
on the GPU unless ``--cpu`` or ``IEAGAN_PLATFORM=cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

# the JAX scripts build G in bfloat16 (scripts/kid_eval.py:53,
# scripts/moments_check.py:53)
GENERATOR_DTYPE = torch.bfloat16


def synchronize(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_setup(run_dir: str, tag: str, device: torch.device) -> dict:
    """What both proof tools read from a run: its generator and config, the
    metric's extractor, mode and dataset, the dataset's minted mu/sigma, a
    maker of bf16 generator functions and the run's seed."""
    from ieagan_torch.eval import fid as fid_mod
    from ieagan_torch.eval.fid_eval_once import load_run_generator

    G, config = load_run_generator(run_dir, tag, device)
    mode = config.get("fid_mode", "clean")
    dataset = config.get("fid_dataset_name", "pxd_sim_test_com")
    trunc = float(config.get("fid_trunc", 1.0))
    ref_mu, ref_sigma = fid_mod.get_reference_statistics(dataset, mode=mode)
    return dict(
        G=G, config=config, mode=mode, dataset=dataset, ref_mu=ref_mu, ref_sigma=ref_sigma,
        extractor=fid_mod.default_extractor(config, device),
        seed=int(config.get("seed", 0)),
        make_gen=lambda: fid_mod.make_generator_fn(
            G, config, trunc=trunc if trunc > 0 else None,
            chunks=int(config.get("fid_gen_chunks", 8)), dtype=GENERATOR_DTYPE))


def seeded(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def host_fid(feats: np.ndarray, ref_mu, ref_sigma) -> float:
    """FID of features against dataset stats with the features' host f64
    moments (``np.cov``)."""
    from ieagan_torch.eval.fid import frechet_distance
    feats = np.asarray(feats, np.float64)
    return frechet_distance(feats.mean(0), np.cov(feats, rowvar=False), ref_mu, ref_sigma)


def main(argv=None) -> dict:
    """Prints the JSON line; returns it with ``seconds``: the generator's
    calls, the feature pass without them, the host FID (its ``sqrtm``) and
    the KID pair."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run-dir", required=True)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--num", type=int, default=16000)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    from ieagan_torch.eval import fid as fid_mod
    from ieagan_torch.train.cli import tool_device

    device = tool_device(args.cpu)
    run = run_setup(args.run_dir, args.tag, device)
    kid_path = fid_mod._stats_path(run["dataset"], run["mode"]).replace(".npz", "_kid.npz")
    ref_feats = np.load(kid_path)["feats"]

    gen, gen_s = run["make_gen"](), [0.0]

    def timed_gen(generator):
        synchronize(device)
        t = time.perf_counter()
        imgs = gen(generator)
        synchronize(device)
        gen_s[0] += time.perf_counter() - t
        return imgs

    t0 = time.perf_counter()
    feats = fid_mod.get_model_features(timed_gen, run["extractor"], num_gen=args.num,
                                       generator=seeded(device, run["seed"]), mode=run["mode"])
    pass_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fid = host_fid(feats, run["ref_mu"], run["ref_sigma"])
    fid_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    kid = fid_mod.kernel_distance(feats.astype(np.float32), ref_feats, seed=run["seed"])
    # the real-vs-real floor of the same feature bank: a KID is read against it
    kid_floor = fid_mod.kid_self_floor(ref_feats, seed=run["seed"])
    kid_s = time.perf_counter() - t0
    line = {"tag": args.tag, "num": int(feats.shape[0]), "fid": float(fid),
            "kid_x1e3": float(kid) * 1e3, "kid_floor_x1e3": float(kid_floor) * 1e3,
            "dataset": run["dataset"]}
    print(json.dumps(line), flush=True)
    return dict(line, seconds={"generation": gen_s[0], "features": pass_s - gen_s[0],
                               "sqrtm": fid_s, "kid": kid_s})


if __name__ == "__main__":
    main()
