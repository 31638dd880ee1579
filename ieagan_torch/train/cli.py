"""Training CLI of the port (twin of the repo's ``train.py``; reference:
train.py:262-786, README.md:8-12).

``python3 train_torch.py --dataroot <data> --outputroot <out> --run-name <name>``.
Every config key is a ``--<key>`` flag (underscores or dashes); flags given
override the JSON ``--config`` (or ``./config.json``), which overrides the
defaults: the reference's argparse-SUPPRESS and dict.update merge. It trains
on the GPU; ``IEAGAN_PLATFORM=cpu`` asks for the CPU, as it does for
``train.py``, and without it a machine with no CUDA device is refused.

Several GPUs, one process each: ``torchrun --nproc-per-node N
train_torch.py ... --mesh N`` (NCCL; gloo on the CPU). ``--mesh`` may be
left out under such a launcher: every process then joins the data axis.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ieagan_torch.core.config import DEFAULT_CONFIG


def _flag_type(default):
    if isinstance(default, bool):
        return lambda s: s.lower() in ("1", "true", "yes", "y")
    if isinstance(default, int):
        return int
    if isinstance(default, float):
        return float
    return str


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="IEA-GAN trainer (PyTorch port)",
                                     argument_default=argparse.SUPPRESS)
    parser.add_argument("--config", type=str, default=argparse.SUPPRESS,
                        help="JSON config path (defaults merged under it)")
    parser.add_argument("--dataroot", type=str, default=argparse.SUPPRESS)
    parser.add_argument("--outputroot", type=str, default=argparse.SUPPRESS)
    parser.add_argument("--run-name", dest="run_name", type=str, default=argparse.SUPPRESS)
    for key, val in DEFAULT_CONFIG.items():
        if key == "run_name":
            continue
        # both spellings: the reference's flags are underscore-style
        # (reference: train.py:279 "--num_workers"), dashes as aliases
        flags = ["--" + key]
        if "_" in key:
            flags.append("--" + key.replace("_", "-"))
        kwargs = dict(dest=key, default=argparse.SUPPRESS,
                      type=str if val is None else _flag_type(val))
        try:
            parser.add_argument(*flags, **kwargs)
        except argparse.ArgumentError:
            pass
    return parser


def load_cli_config(argv=None) -> dict:
    """The run's config: defaults < JSON config < flags given."""
    args = vars(build_parser().parse_args(argv))
    config = dict(DEFAULT_CONFIG)
    config_path = args.pop("config", None)
    if config_path:
        with open(config_path, "r", encoding="utf-8") as fp:
            config.update(json.load(fp))
    elif os.path.exists("config.json"):
        # the reference loads ./config.json from the working dir (train.py:779-782)
        with open("config.json", "r", encoding="utf-8") as fp:
            config.update(json.load(fp))
    config.update(args)
    return config


def platform_device() -> str:
    """``cpu`` when ``IEAGAN_PLATFORM`` asks for it, else ``cuda``."""
    platform = os.environ.get("IEAGAN_PLATFORM", "").strip().lower()
    if platform in ("", "cuda", "gpu"):
        return "cuda"
    if platform == "cpu":
        return "cpu"
    raise SystemExit(f"IEAGAN_PLATFORM={platform!r}: the port runs on 'cuda' or 'cpu'")


def tool_device(cpu: bool = False):
    """The device of a user tool (``python -m ieagan_torch.<pkg>.<tool>``):
    the CPU when the tool's ``--cpu`` flag or ``IEAGAN_PLATFORM=cpu`` asks
    for it, else the GPU. With neither and no CUDA device the tool exits
    with an error; it never carries on on the CPU unasked."""
    from ieagan_torch.train.driver import resolve_device
    try:
        return resolve_device("cpu" if cpu else platform_device())
    except RuntimeError as e:
        raise SystemExit(str(e)) from None


def main(argv=None):
    """Parse the flags, join the launcher's process group (a no-op for one
    process), make the run dirs on rank 0 and train (``train.py:103-118``)."""
    try:
        sys.stdout.reconfigure(line_buffering=True)
    except (AttributeError, ValueError):
        pass
    config = load_cli_config(argv)
    if "outputroot" not in config:
        raise SystemExit("the --outputroot flag is required")
    from ieagan_torch.parallel import distributed
    from ieagan_torch.train.driver import resolve_device, run
    from ieagan_torch.utils.run_dirs import initialize_directories
    platform = platform_device()
    try:
        device = resolve_device(platform)
    except RuntimeError as e:
        raise SystemExit(f"train_torch: {e}") from None
    # ranks wait in a collective while rank 0 runs the FID test: the group's
    # timeout outlasts the test's own
    distributed.initialize(device_type=platform,
                           timeout_s=float(config.get("fid_subprocess_timeout", 3600)) + 1800)
    try:
        error = None
        if distributed.rank() == 0:
            try:
                initialize_directories(config)
            except RuntimeError as e:  # an existing run dir: every rank stops
                error = str(e)
        error = distributed.broadcast_object(error)
        if error is not None:
            raise SystemExit(f"train_torch: {error}")
        return run(config, device=distributed.local_device(platform))
    finally:
        distributed.shutdown()
