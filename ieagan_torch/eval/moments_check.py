"""The device-f32 FID moments against host-f64 ``np.cov`` on the same images
(twin of ``scripts/moments_check.py``).

    python -m ieagan_torch.eval.moments_check --run-dir <out>/<run> --tag best0 \\
        [--num 16000]

The driver's FID test accumulates the features' pilot-centred sum and XᵀX
on the device in f32 (``eval/fid.py::get_model_features(...,
return_moments=True)``); the proof tools take host f64 ``np.cov``. This
tool generates the same images twice from the run's seed (the bf16
generator of ``eval/kid_eval.py``), scores them both ways against the minted
dataset stats, and prints one JSON line: ``{"fid_device_f32", "fid_host_f64",
"rel_diff", "num"}``. Runs on the GPU unless ``IEAGAN_PLATFORM=cpu`` asks
for the CPU.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run-dir", required=True)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--num", type=int, default=16000)
    args = ap.parse_args(argv)

    from ieagan_torch.eval import fid as fid_mod
    from ieagan_torch.eval.kid_eval import host_fid, run_setup, seeded
    from ieagan_torch.train.cli import tool_device

    device = tool_device()
    run = run_setup(args.run_dir, args.tag, device)
    common = dict(num_gen=args.num, mode=run["mode"])
    # device path: f32 pilot-centred moments, nothing bulky leaves the device
    mu_d, sigma_d, n_d = fid_mod.get_model_features(
        run["make_gen"](), run["extractor"], generator=seeded(device, run["seed"]),
        return_moments=True, **common)
    fid_dev = fid_mod.frechet_distance(np.asarray(mu_d, np.float64),
                                       np.asarray(sigma_d, np.float64),
                                       run["ref_mu"], run["ref_sigma"])
    # host path: the same seed, so the same images and features; f64 np.cov
    feats = fid_mod.get_model_features(run["make_gen"](), run["extractor"],
                                       generator=seeded(device, run["seed"]), **common)
    fid_host = host_fid(feats, run["ref_mu"], run["ref_sigma"])
    rel = abs(fid_dev - fid_host) / max(abs(fid_host), 1e-12)
    line = {"fid_device_f32": float(fid_dev), "fid_host_f64": float(fid_host),
            "rel_diff": float(rel), "num": int(n_d)}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
