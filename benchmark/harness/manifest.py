"""The benchmark's data: ``BENCHMARK.json`` at the root of a checkout and
the files it names by name under that checkout's ``benchmark/``.

  configs/<config>.json      a configuration: ``source``, ``config`` (the
                             keys set over the port's defaults), ``assumed``,
                             ``reduced``
  workloads/<cell>.json      a cell: ``precision``, the comparison's
                             ``limits``, ``why``
  traffic/<mix>.json         a traffic mix: ``kind`` (the driver
                             ``traffic/<kind>.py``) and its parameters
  traffic/<kind>.py          a driver: ``declare(run)`` sets what one call
                             of the window is (``Run.family``, ``unit``,
                             ``units_per_call``, ``flops_per_call``,
                             ``attention_sites``), ``run(run, mode, fault)``
                             declares, sets up, runs the window and compares
  metrics/<metric>.py        a metric's reader, ``read(run) -> float | None``

A new configuration, cell, mix or metric is a new file and a new entry.
Everything is read under the root it is given (by default this checkout),
and a cell's driver and readers under its cell's root, so a copy of the tree
runs its own files.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]      # benchmark/
ROOT = HERE.parent                               # the checkout


def bench_dir(root: Path = ROOT) -> Path:
    return Path(root) / HERE.name


def load_json(path: Path):
    with open(path, encoding="utf-8") as fp:
        return json.load(fp)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config_file: dict
    workload: dict
    traffic_name: str
    traffic: dict
    end_to_end: list = field(default_factory=list)   # manifest entries for this cell
    per_layer: list = field(default_factory=list)
    root: Path = ROOT                                # the checkout it was read from

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    def metrics(self, traced: bool) -> list:
        return self.per_layer if traced else self.end_to_end


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT, bench: dict | None = None) -> Cell:
    """The cell ``name`` of the manifest, with its files read."""
    root = Path(root)
    bench = bench if bench is not None else manifest(root)
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = entries[0]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        config_file=load_json(root / cfg_entry["file"]),
        workload=load_json(bench_dir(root) / "workloads" / f"{name}.json"),
        traffic_name=w["traffic"],
        traffic=load_json(bench_dir(root) / "traffic" / f"{w['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)], root=root)


def load_module(path: Path, name: str):
    """A module from a file whose name need not be an identifier."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(kind: str, root: Path = ROOT):
    return load_module(bench_dir(root) / "traffic" / f"{kind}.py", f"bench_traffic_{kind}")


def reader(metric: str, root: Path = ROOT):
    return load_module(bench_dir(root) / "metrics" / f"{metric}.py",
                       "bench_metric_" + metric.replace(".", "_").replace("-", "_"))


def peaks(root: Path = ROOT) -> dict:
    return load_json(bench_dir(root) / "work" / "peaks.json")
