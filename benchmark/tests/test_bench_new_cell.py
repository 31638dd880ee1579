"""A configuration, a traffic mix of a kind the benchmark does not have, its
driver and its cell join the benchmark as new files and new entries of
``BENCHMARK.json``, in a copy of the tree, and the copy's harness reads
them with no file of it edited.

The new files are under ``new_cell/``: an image sampler (``traffic/
sample.py``) that runs the port's ``Generator`` on the CPU, declaring its
calls of the family ``generate`` with the unit ``images``. The CPU trace has
no device events, so each call gains a kernel and each attention span a
launch of B1 and its kernel, as ``test_bench_run.py`` builds a trace."""

import hashlib
import json
import shutil
from pathlib import Path

import pytest

from benchmark import run as bench_run
from benchmark.harness import manifest, trace

ROOT = Path(__file__).resolve().parents[2]
NEW = Path(__file__).resolve().parent / "new_cell"
ENTRIES = json.loads((NEW / "entries.json").read_text())
CELL = ENTRIES["workloads"][0]["name"]


def _hashes(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def _with_device_events(chrome_events):
    """``trace.chrome_events`` with a kernel over the middle of each
    ``bench.call`` and, in each attention span, a launch of B1 and its
    kernel."""
    def events(prof):
        ev = chrome_events(prof)
        added, corr = [], 10 ** 6
        for e in ev:
            if e.get("cat") != "user_annotation":
                continue
            if e["name"] == "bench.call":
                added.append({"ph": "X", "cat": "kernel", "name": "sm90_xmma_conv",
                              "ts": e["ts"] + e["dur"] / 4, "dur": e["dur"] / 2, "pid": 0,
                              "tid": 7, "args": {}})
            elif e["name"].startswith("ieagan.attn."):
                corr += 1
                added += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                           "ts": e["ts"], "dur": 1, "pid": e.get("pid"), "tid": e.get("tid"),
                           "args": {"correlation": corr}},
                          {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7,
                           "name": "void attention_fwd_kernel<float, 32, 128>(x)",
                           "ts": e["ts"] + 1, "dur": e["dur"], "args": {"correlation": corr}}]
        return ev + added
    return events


@pytest.fixture
def checkout(tmp_path):
    """A copy of the benchmark with the new cell's files and entries added,
    and the hashes of every file the copy had before."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _hashes(root)
    for src in sorted(NEW.rglob("*")):
        if src.is_file() and src.parent != NEW and "__pycache__" not in src.parts:
            dst = root / "benchmark" / src.relative_to(NEW)
            assert not dst.exists(), dst
            dst.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(src, dst)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"] += ENTRIES["configs"]
    bench["workloads"] += ENTRIES["workloads"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ENTRIES["joins"]:
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root, before


def test_a_cell_of_a_new_kind_joins_as_new_files(checkout, monkeypatch):
    import torch
    root, before = checkout
    monkeypatch.setattr(trace, "chrome_events", _with_device_events(trace.chrome_events))
    cell = manifest.cell(CELL, root)
    assert cell.kind == "sample" and cell.root == root
    cpu = torch.device("cpu")
    untraced = bench_run.measure(cell, 2 ** 31 + 11, 0.3, False, cpu)
    traced = bench_run.measure(cell, 2 ** 31 + 12, 0.3, True, cpu)
    assert (untraced.family, untraced.unit) == ("generate", "images")
    assert untraced.correct and traced.correct, (untraced.checks, traced.checks)

    e2e = bench_run.result(untraced, "cpu", 1)["metrics"]
    assert {"setup_s", "gen_call_p90_ms", "peak_gib"} <= set(e2e)
    assert manifest.reader("gen_events_per_s", root).read(untraced) is None
    per_layer = bench_run.result(traced, "cpu", 1)["metrics"]
    gen = [m["name"] for m in cell.per_layer if m["name"].endswith(".gen")]
    assert gen and set(gen) <= set(per_layer), (gen, per_layer)
    assert all(per_layer[m]["value"] is not None for m in gen)
    assert per_layer["sn_hit_share.gen"]["value"] == 1.0   # a span reading: every pass hits
    assert 0 < per_layer["attn_roofline.gen"]["value"] <= 100

    # no file the copy had is edited; BENCHMARK.json only gains entries
    after = _hashes(root)
    assert {k: after[k] for k in before if k != "BENCHMARK.json"} == \
        {k: v for k, v in before.items() if k != "BENCHMARK.json"}
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"] = bench["configs"][:-1]
    bench["workloads"] = bench["workloads"][:-1]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ENTRIES["joins"]:
            assert m["workloads"].pop() == CELL
    assert bench == json.loads((ROOT / "BENCHMARK.json").read_text())
