"""Run-directory layout (copy of ``ieagan_tpu/utils/run_dirs.py``;
reference: utils/configuration.py:7-65).

Creates ``<outputroot>/<run_name>/{samples,weights,logs}``, dumps a
timestamped config copy, and refuses to reuse an existing run dir unless
resuming.
"""

from __future__ import annotations

import datetime
import json
import pathlib


def initialize_directories(configuration: dict):
    outputroot = pathlib.Path(configuration["outputroot"])
    runpath = outputroot / configuration["run_name"]
    resume = bool(configuration.get("resume", False))
    if not outputroot.exists():
        raise AssertionError(
            f"Output root folder '{outputroot.absolute()}' does not exist")
    try:
        runpath.mkdir(exist_ok=resume)
    except FileExistsError as error:
        raise RuntimeError(
            "'resume' is set to False and run directory "
            f"'{runpath.absolute()}' already exists.") from error
    stamp = datetime.datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
    with open(runpath / f"{stamp}_config.json", "w", encoding="utf-8") as fp:
        json.dump({k: v for k, v in configuration.items()
                   if _jsonable(v)}, fp, indent=4)
    for sub in ("samples", "weights", "logs"):
        (runpath / sub).mkdir(exist_ok=resume)


def _jsonable(v) -> bool:
    return isinstance(v, (str, int, float, bool, type(None), list, dict))


def write_metadata(configuration: dict, state: dict):
    """metalog.txt run metadata (reference: utils/__init__.py:671-686)."""
    path = (pathlib.Path(configuration["outputroot"]) / configuration["run_name"]
            / "logs" / "metalog.txt")
    with open(path, "w") as fp:
        fp.write("datetime: %s\n" % str(datetime.datetime.now()))
        fp.write("state: %s\n" % str(state))
