"""``harness/spans.py``: the program's spans reduced from synthetic Chrome
events, and the readings of a run."""

import json

import pytest

from bench_runs import declared
from benchmark.harness import manifest, spans, trace

CELLS = {w["name"]: w for w in manifest.manifest()["workloads"]}
FAMILY = {name: declared(name, False).family for name in CELLS}


def _span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


def _launch(corr, ts, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 5,
            "pid": 1, "tid": tid, "args": {"correlation": corr}}


def _kernel(corr, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": f"k{corr}", "ts": ts, "dur": dur, "pid": 0,
            "tid": 7, "args": {"correlation": corr}}


def train_events():
    """One window of two calls. Thread 1: a step [0, 900) holding a D phase
    [10, 400) (forward [20, 200), backward [200, 390)), a G phase [400, 780)
    (an update [700, 770)), the EMA [780, 800) and a wait [800, 900); thread
    2, the autograd engine's, an attention backward [250, 300) and an SN
    span [260, 270) in it."""
    return [
        _span("bench.window", 0, 1000), _span("bench.call", 0, 500), _span("bench.call", 500, 500),
        _span("ieagan.train.step", 0, 900), _span("ieagan.train.d_phase", 10, 390),
        _span("ieagan.train.d_forward", 20, 180), _span("ieagan.train.d_backward", 200, 190),
        _span("ieagan.train.g_phase", 400, 380), _span("ieagan.train.update", 700, 70),
        _span("ieagan.train.ema", 780, 20), _span("ieagan.train.wait", 800, 100),
        _span("ieagan.attn.d_sa.bwd", 250, 50, tid=2), _span("ieagan.sn", 260, 10, tid=2),
        _launch(1, 30), _kernel(1, 100, 100),                  # D forward
        _launch(2, 265, tid=2), _kernel(2, 300, 40),           # on thread 2, in the bwd span
        _launch(3, 450), _kernel(3, 600, 100),                 # G phase
        _launch(4, 450), _kernel(4, 960, 80, "gpu_memcpy"),    # runs past the window's end
        _launch(5, 810), _kernel(5, 820, 10),                  # in the wait
        _launch(6, 710), _kernel(6, 720, 20),                  # G's update
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 25, "dur": 10, "pid": 1, "tid": 1},
    ]


def test_reduction():
    s = spans.reduce(train_events())
    assert s.calls == 2
    assert s.window_s == pytest.approx(1e-3)
    assert s.kernels == 5
    assert s.device_s == pytest.approx((100 + 40 + 100 + 40 + 10 + 20) * 1e-6)
    by = s.by_name
    # the kernel launched on thread 2 counts under the main thread's
    # backward and phase, and under the span of its own thread
    for name in ("ieagan.train.d_backward", "ieagan.train.d_phase", "ieagan.train.step",
                 "ieagan.attn.d_sa.bwd", "ieagan.sn"):
        assert by[name].launches >= 1, name
    assert by["ieagan.train.d_phase"].device_s == pytest.approx(140e-6)
    assert by["ieagan.train.d_phase"].launches == 2
    # a copy clipped to the window's last 40 us
    assert by["ieagan.train.g_phase"].device_s == pytest.approx(160e-6)
    assert by["ieagan.train.g_phase"].launches == 2
    assert by["ieagan.train.step"].device_s == pytest.approx(310e-6)
    # nested spans: host time is the spans' own, self time what no child covers
    assert by["ieagan.train.step"].host_s == pytest.approx(900e-6)
    assert by["ieagan.train.step"].self_s == pytest.approx((900 - 390 - 380 - 20 - 100) * 1e-6)
    assert by["ieagan.train.g_phase"].self_s == pytest.approx((380 - 70) * 1e-6)
    assert by["ieagan.train.d_phase"].self_s == pytest.approx((390 - 180 - 190) * 1e-6)
    assert by["ieagan.attn.d_sa.bwd"].self_s == pytest.approx(40e-6)
    assert by["ieagan.sn"].count == 1
    # each device event once for a group of names
    assert s.under(lambda n: n.startswith("ieagan.train."))[0] == pytest.approx(310e-6)
    lines = spans.table(s)
    assert any(ln.startswith("ieagan.train.d_phase") for ln in lines)
    assert "host_issue_ms.train 0.400000 ms" in lines


def test_no_program_spans_read_nothing():
    events = [e for e in train_events() if not e["name"].startswith("ieagan.")]
    s = spans.reduce(events)
    assert s.by_name == {} and s.kernels == 5
    assert all(reading(s) is None for _, reading in spans.READINGS.values())


def test_driver_trace_without_a_window(tmp_path, capsys):
    """The training driver's trace: no window, calls counted by ``--per``."""
    events = [e for e in train_events() if not e["name"].startswith("bench.")]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert spans.main([str(path), "--per", "ieagan.train.step"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("spans: 1 calls")
    assert "d_phase_ms.train 0.140000 ms" in out


def _run(cell, traced, with_spans=True):
    r = declared(cell, traced)
    if traced:
        r.trace = trace.summarize(train_events())
        if with_spans:
            gen = [_span("ieagan.gen.call", 0, 450), _span("ieagan.gen.call", 500, 450),
                   _span("ieagan.sn", 40, 10), _span("ieagan.attn.rr_g", 20, 20)]
            r.trace.spans = spans.reduce(train_events() + gen)
    return r


@pytest.mark.parametrize("metric", sorted(spans.READINGS))
def test_readers(metric):
    family = spans.READINGS[metric][0]
    mine = [c for c in CELLS if FAMILY[c] == family]
    other = [c for c in CELLS if FAMILY[c] != family]
    assert mine and other
    value = spans.read(_run(mine[0], True), metric)
    assert value is not None and value >= 0
    assert spans.read(_run(mine[0], False), metric) is None
    assert spans.read(_run(mine[0], True, with_spans=False), metric) is None
    assert spans.read(_run(other[0], True), metric) is None
