"""Training-dynamics A/B at small scale (resolution 64, H_base 1, 40
sensors): the ``ours`` arm of ``scripts/dynamics_compare.py`` through the
port's driver.

    python -m ieagan_torch.train.dynamics_compare ours --dataroot D \\
        --outputroot O [--run-name dyn64_ours] [--steps 1500] [--epochs 3]

The JAX script compares the reference trainer (``ref``, run as an oracle
from a checkout of the upstream code) with its own driver (``ours``) on one
event tree under the reference's hyperparameters with only the geometry
scaled down (``OVERRIDES``). The port runs ``ours``; ``ref`` needs the
upstream trainer, which is not in this repository, and exits with an error
saying so. Runs on the GPU unless ``IEAGAN_PLATFORM=cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import os

# the regime under test: flagship knobs at 64 px (reference config.json with
# only the geometry scaled down; RR_D/RRM keep their 32-channel and
# 512-hidden sizes, so D_ch stays 32); a copy of scripts/dynamics_compare.py:32-44
OVERRIDES = dict(
    resolution=64, H_base=1, device="cpu",
    num_workers=2, pin_memory=False, shuffle=True,
    # everything but training off (no FID stats at this scale)
    test_every=10 ** 9, save_every=10 ** 9, sample_every=10 ** 9,
    sv_log_interval=10 ** 9, log_interval=10,
    # The published config has clip_norm=None, under which the reference's G
    # never steps (its G.optim.step() sits inside the clip guard,
    # train_fns.py:190-192). A huge bound leaves the gradients alone and arms
    # the reference's G update: the A/B is about the dynamics, not the bug.
    clip_norm=1e9,
)


def ours_config(args) -> dict:
    """The ``ours`` arm's driver config (``scripts/dynamics_compare.py:76-81``)."""
    from ieagan_torch.core.config import DEFAULT_CONFIG
    config = dict(DEFAULT_CONFIG)
    config.update(OVERRIDES)
    del config["device"]
    config.update(dataroot=args.dataroot, outputroot=args.outputroot,
                  run_name=args.run_name, num_epochs=args.epochs,
                  stop_after=args.steps, use_pallas_attention=False)
    return config


def run_ours(args):
    from ieagan_torch.train.cli import tool_device
    from ieagan_torch.train.driver import run
    from ieagan_torch.utils.run_dirs import initialize_directories

    device = tool_device()
    config = ours_config(args)
    os.makedirs(config["outputroot"], exist_ok=True)
    initialize_directories(config)
    return run(config, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("side", choices=["ref", "ours"])
    ap.add_argument("--dataroot", required=True)
    ap.add_argument("--outputroot", required=True)
    ap.add_argument("--run-name", default=None)
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--epochs", type=int, default=3)
    args = ap.parse_args(argv)
    if args.run_name is None:
        args.run_name = f"dyn64_{args.side}"
    if args.side == "ref":
        raise SystemExit(
            "dynamics_compare ref: the 'ref' arm trains the upstream reference code "
            "(train.py and config.json of a checkout named by $IEAGAN_REFERENCE), which is not "
            "in this repository; the port runs the 'ours' arm only")
    return run_ours(args)


if __name__ == "__main__":
    main()
