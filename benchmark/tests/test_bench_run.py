"""``run.py`` itself: no result without a card or without the program, the
trace's reduction, the metric readers, and a short run of a cell on the
card (a chip test)."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from bench_runs import declared
from benchmark import run as bench_run
from benchmark.harness import manifest, readings, spans, trace
from benchmark.harness.run_state import Check

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in manifest.manifest()["workloads"]]


def _run(cwd, env=None):
    cmd = [sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed",
           str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"]
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    import os
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(ROOT, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_the_benchmark_alone_gives_no_result(tmp_path):
    """A directory with BENCHMARK.json and the benchmark's files only."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def _events(kernels, calls, window=(0, 1000)):
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": window[0],
           "dur": window[1] - window[0]}]
    ev += [{"ph": "X", "cat": "user_annotation", "name": "bench.call", "ts": t, "dur": d}
           for t, d in calls]
    ev += [{"ph": "X", "cat": "kernel", "name": n, "ts": t, "dur": d} for n, t, d in kernels]
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "ts": 0, "dur": 400})
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 600, "dur": 300})
    return ev


def test_trace_reduction():
    kernels = [("void (anonymous namespace)::attention_fwd_kernel<float, 32, 128>(float*)",
                100, 100),
               ("sm90_xmma_conv", 150, 150),      # overlaps the first
               ("elementwise", 700, 100),
               ("before the window", -50, 40)]
    t = trace.summarize(_events(kernels, [(0, 500), (500, 500)]))
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx(300e-6)   # [100, 300) and [700, 800)
    assert t.calls == 2
    assert len(t.kernels) == 3
    assert t.device_ops[0][0] == "sm90_xmma_conv"
    # gaps by the host op at their middle: [0, 100) in conv2d; [300, 700)
    # between ops, before copy_; [800, 1000) after the last op
    gaps = dict(t.idle_gaps)
    assert gaps["aten::conv2d"] == pytest.approx(100e-6)
    assert gaps["between ops, before aten::copy_"] == pytest.approx(400e-6)
    assert gaps["between ops, before the end"] == pytest.approx(200e-6)
    seconds, n = t.kernel_seconds(readings.ATTENTION_KERNELS)
    assert n == 1 and seconds == pytest.approx(100e-6)


def _run_state(cell, traced, **kw):
    return declared(cell, traced, dict(manifest.cell(cell).config_file["config"], n_classes=40),
                    **kw)


# the program's spans in each of two calls, of a generator call and of a step
PROGRAM_SPANS = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": t0 + t, "dur": d}
                 for t0 in (0, 500_000)
                 for n, t, d in (("ieagan.gen.call", 0, 300_000), ("ieagan.sn.cached", 10, 10),
                                 ("ieagan.train.step", 0, 400_000), ("ieagan.sn", 20, 10),
                                 ("ieagan.train.d_phase", 0, 100_000),
                                 ("ieagan.train.g_phase", 100_000, 100_000),
                                 ("ieagan.train.update", 150_000, 10_000),
                                 ("ieagan.train.wait", 300_000, 100_000))]


@pytest.mark.parametrize("cell", CELLS)
def test_readers(cell):
    c = manifest.cell(cell)
    events = [("void attention_fwd_kernel<float, 32, 128>(x)", 0, 1e6)]
    ev = _events(events, [(0, 500_000), (500_000, 500_000)], (0, 1e6)) + PROGRAM_SPANS
    t = trace.summarize(ev)
    t.spans = spans.reduce(ev)
    r = _run_state(cell, True, trace=t, calls=2, units_per_call=4, flops_per_call=1e12,
                   call_seconds=[0.4, 0.6], window_s=1.0, setup_s=12.0,
                   memory_peak_bytes=2 ** 30)
    got = bench_run.result(r, "test card", 1)
    for m in c.per_layer:
        assert m["name"] in got["metrics"], m["name"]
        if m["unit"] == "%":
            assert 0 <= got["metrics"][m["name"]]["value"] <= 100
    assert got["device"]["busy_s"] == pytest.approx(1.0)
    r.traced, r.trace = False, None
    got = bench_run.result(r, "test card", 1)
    assert set(got["metrics"]) == {m["name"] for m in c.end_to_end}
    assert got["metrics"]["setup_s"]["value"] == 12.0
    assert got["metrics"]["peak_gib"]["value"] == 1.0
    assert list(got)[-1] == "checks"


def test_correct_needs_every_check_within_its_limit():
    r = _run_state(CELLS[0], False)
    assert not r.correct
    r.checks = [Check("a", 0.5, 1.0), Check("b", 1.0, 1.0)]
    assert r.correct
    r.checks.append(Check("c", float("nan"), 1.0))
    assert not r.correct


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, cuda_device):
    """Two seconds of the cell on the card: a result line of the contract's
    shape, correct."""
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          str(2 ** 31 + 77), "--seconds", "2", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
