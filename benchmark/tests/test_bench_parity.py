"""Every reader that the benchmark had before its readers keyed on the
family a driver declares (``Run.family``, ``unit``, ``attention_sites``) in
place of the cell's traffic kind reads as it did then, on the synthetic runs
of ``test_bench_run.py`` and ``test_bench_spans.py``. The values are pinned
from the readers keyed on the traffic kind."""

import pytest

from bench_runs import declared
from benchmark import run as bench_run
from benchmark.harness import manifest, spans, trace
from test_bench_run import _events
from test_bench_spans import _span, train_events

# cell -> metric -> value, each metric of the cell in BENCHMARK.json then
BEFORE = {
    "iea-gan.gen-4ev": {
        "setup_s": 12.0,
        "gen_events_per_s": 8.0,
        "gen_call_p90_ms": 600.0,
        "peak_gib": 1.0,
        "launches_per_call.gen": 0.5,
        "device_idle.gen": 0.0,
        "mfu.gen": 0.40404040404040403,
        "attn_roofline.gen": 1.9639402985074628e-05,
    },
    "iea-gan.train-3ev": {
        "setup_s": 12.0,
        "train_images_per_s": 8.0,
        "peak_gib": 1.0,
        "launches_per_step.train": 0.5,
        "device_idle.train": 0.0,
        "mfu.train": 0.20222446916076844,
        "attn_roofline.train": 0.17611636589855578,
    },
    "pegan.gen-4ev": {
        "setup_s": 12.0,
        "gen_events_per_s": 8.0,
        "gen_call_p90_ms": 600.0,
        "peak_gib": 1.0,
        "launches_per_call.gen": 0.5,
        "device_idle.gen": 0.0,
        "mfu.gen": 0.40404040404040403,
        "attn_roofline.gen": 0.14641933963636364,
    },
}

# cell -> span reading -> value on test_bench_spans' run with a generator
# call's spans; every other reading of the cell is None
SPANS_BEFORE = {
    "iea-gan.gen-4ev": {
        "host_issue_ms.gen": 0.45,
        "sn_ms.gen": 0.009999999999999998,
        "attn_ms.gen": 0.06999999999999999,
    },
    "iea-gan.train-3ev": {
        "host_issue_ms.train": 0.4,
        "d_phase_ms.train": 0.06999999999999999,
        "g_phase_ms.train": 0.07999999999999999,
        "update_ms.train": 0.009999999999999998,
        "sn_ms.train": 0.009999999999999998,
        "attn_ms.train": 0.06999999999999999,
    },
    "pegan.gen-4ev": {
        "host_issue_ms.gen": 0.45,
        "sn_ms.gen": 0.009999999999999998,
        "attn_ms.gen": 0.06999999999999999,
    },
}


def _run(cell, traced, t=None):
    return declared(cell, traced, dict(manifest.cell(cell).config_file["config"], n_classes=40),
                    trace=t, calls=2, units_per_call=4, flops_per_call=1e12,
                    call_seconds=[0.4, 0.6], window_s=1.0, setup_s=12.0,
                    memory_peak_bytes=2 ** 30)


def _same(got, want):
    assert (got is None) == (want is None), (got, want)
    if want is not None:
        assert got == pytest.approx(want, rel=1e-12, abs=0.0)


@pytest.mark.parametrize("cell", sorted(BEFORE))
def test_readers_read_as_before(cell):
    c = manifest.cell(cell)
    t = trace.summarize(_events([("void attention_fwd_kernel<float, 32, 128>(x)", 0, 1e6)],
                                [(0, 500_000), (500_000, 500_000)], (0, 1e6)))
    untraced, traced = bench_run.result(_run(cell, False), "test card", 1)["metrics"], \
        bench_run.result(_run(cell, True, t), "test card", 1)["metrics"]
    for name, want in BEFORE[cell].items():
        is_e2e = any(m["name"] == name for m in c.end_to_end)
        got = (untraced if is_e2e else traced).get(name, {}).get("value")
        _same(got, want)


@pytest.mark.parametrize("cell", sorted(SPANS_BEFORE))
def test_span_readings_read_as_before(cell):
    t = trace.summarize(train_events())
    gen = [_span("ieagan.gen.call", 0, 450), _span("ieagan.gen.call", 500, 450),
           _span("ieagan.sn", 40, 10), _span("ieagan.attn.rr_g", 20, 20)]
    t.spans = spans.reduce(train_events() + gen)
    r = _run(cell, True, t)
    for name in ("host_issue_ms.gen", "sn_ms.gen", "attn_ms.gen", "host_issue_ms.train",
                 "d_phase_ms.train", "g_phase_ms.train", "update_ms.train", "sn_ms.train",
                 "attn_ms.train"):
        _same(spans.read(r, name), SPANS_BEFORE[cell].get(name))
