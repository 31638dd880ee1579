"""BENCHMARK.json against the benchmark's contract, and every name in it
against the files that the harness finds by name."""

import json
import math
import re
from pathlib import Path

import pytest

from bench_runs import declared
from benchmark.harness import manifest, spans

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
E2E = {m["name"]: m for m in BENCH["end_to_end"]}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])


def test_metric_names_unique_across_sections():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))


def test_end_to_end_metrics():
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    assert len(E2E) - 1 <= 4, "at most four end-to-end metrics besides setup_s"
    for m in E2E.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_per_layer_metrics_move_what_their_cells_report():
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in E2E
        moved = E2E[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert "workloads" not in moved or cell in moved["workloads"], (m["name"], cell)


def test_one_layer_name_per_layer():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(len(layer) <= 200 for layer in layers)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_and_metrics(cell):
    c = manifest.cell(cell, ROOT, BENCH)
    assert c.chips in (1, 4)
    e2e = [m["name"] for m in c.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    assert c.workload["config"] == c.config_name and c.workload["traffic"] == c.traffic_name
    assert (manifest.HERE / "traffic" / f"{c.kind}.py").is_file()
    assert c.workload["precision"] in manifest.peaks()["precisions"]
    for m in c.end_to_end + c.per_layer:
        assert hasattr(manifest.reader(m["name"]), "read")


@pytest.mark.parametrize("cell", CELLS)
def test_drivers_declare_their_calls(cell):
    """What the readers key on, as each cell's driver declares it."""
    r = declared(cell, False)
    assert (r.family, r.unit) in (("generate", "events"), ("train", "images"))
    assert r.units_per_call > 0 and r.flops_per_call > 0
    assert all(len(shape) == 5 for _, shape, _, _ in r.attention_sites)


def test_span_metrics_are_span_readings_of_their_cells_family():
    for m in BENCH["per_layer"]:
        if m["source"] == "program_span":
            family = spans.READINGS[m["name"]][0]
            assert all(declared(c, False).family == family for c in m["workloads"]), m["name"]


def test_four_chip_cells_within_their_share():
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, math.floor(0.25 * len(BENCH["workloads"])))


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(entry):
    path = ROOT / entry["file"]
    assert path.is_file() and entry["file"].startswith("benchmark/")
    files = [c["file"] for c in BENCH["configs"]]
    assert files.count(entry["file"]) == 1
    data = json.loads(path.read_text())
    assert data["source"] == entry["source"]
    assert data["reduced"] == entry["reduced"] == []
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


def test_budget_fits_a_full_check():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_paths_hold_only_the_benchmark():
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and not p.startswith("/")
        assert ".." not in p.split("/")
