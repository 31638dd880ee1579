"""The BigGAN-deep 256 sampler cell (``biggan-deep-256.sampler-128``): its
driver in a copy of the tree on the CPU at a small width, where the program
passes and the bfloat16 control and an emptied image fail ``tanh_gap``; its
work counts against ``FlopCounterMode`` and the attention calls the port
makes; and the ``.sampler`` readers, the ``.gen`` device readers' twins that
move ``gen_call_p90_ms``."""

import json
import shutil
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_runs import declared
from benchmark import run as bench_run
from benchmark.harness import manifest, trace
from benchmark.reference import biggan_deep as ref
from benchmark.work import biggan_deep as work

ROOT = Path(__file__).resolve().parents[2]
CELL = "biggan-deep-256.sampler-128"
# the published configuration at G_ch 8 and 10 classes; 4 images a call
SMALL = dict(G_ch=8, n_classes=10)
SMALL_TRAFFIC = dict(images_per_call=4, sample_calls=2, sample_span=2, reference_images=2)


def small_config():
    from ieagan_torch.core.config import DEFAULT_CONFIG
    return {**DEFAULT_CONFIG, **manifest.cell(CELL).config_file["config"], **SMALL}


@pytest.fixture(scope="module")
def copy_root(tmp_path_factory):
    """A checkout holding BENCHMARK.json and the benchmark's files only."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return root


def drive(root, mode="program", fault=None):
    cell = manifest.cell(CELL, root)
    assert cell.kind == "sampler" and cell.root == root
    cell.traffic = dict(cell.traffic, **SMALL_TRAFFIC)
    return bench_run.measure(cell, 2 ** 31 + 23, 0.5, False, torch.device("cpu"), mode=mode,
                             fault=fault, config=small_config())


def test_the_program_passes_in_a_copy_of_the_tree(copy_root):
    run = drive(copy_root)
    assert (run.family, run.unit, run.units_per_call) == ("generate", "images", 4)
    assert run.correct, [(c.name, c.value, c.limit) for c in run.checks]
    assert run.notes["compared"]["calls"] == 2
    assert run.notes["compared"]["values"] == 2 * 4 * 256 * 256 * 3
    metrics = bench_run.result(run, "cpu", 1)["metrics"]
    assert {"setup_s", "gen_call_p90_ms"} <= set(metrics)
    assert "gen_events_per_s" not in metrics     # an events rate reads no images


@pytest.mark.parametrize("mode,fault", [("control", None), ("program", "altered")])
def test_the_control_and_an_emptied_image_fail(copy_root, mode, fault):
    run = drive(copy_root, mode, fault)
    assert not run.correct, [(c.name, c.value, c.limit) for c in run.checks]


def test_forward_flops_match_the_counter():
    from ieagan_torch.models.generator import Generator
    cfg = small_config()
    G = Generator.from_config(dict(cfg, use_pallas_attention=False))
    G.load_state_dict({k: torch.randn(s) if k.endswith(("weight", "u")) else torch.ones(s)
                       for k, (s, _) in ref.g_spec(cfg).items()}, strict=True)
    G.eval()
    z, y = torch.randn(2, cfg["dim_z"]), torch.arange(2)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        assert G(z, y).shape == (2, 256, 256, 3)
    assert work.g_forward(cfg, 2) == pytest.approx(fc.get_total_flops(), rel=1e-4)


def test_attention_sites_are_the_calls_the_model_makes(monkeypatch):
    import ieagan_torch.ops.attention as att
    from ieagan_torch.models.generator import Generator
    cfg = dict(small_config(), use_pallas_attention=False)
    seen, plain = [], att.dot_softmax_attention

    def spy(q, k, v, scale=1.0, fused=False):
        seen.append((q.shape[0], q.shape[1], k.shape[1], q.shape[2], v.shape[2]))
        return plain(q, k, v, scale, fused)

    monkeypatch.setattr(att, "dot_softmax_attention", spy)
    G = Generator.from_config(cfg)
    G.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        G.eval()(torch.randn(3, cfg["dim_z"]), torch.arange(3))
    assert [shape for _, shape, _, _ in work.sites(cfg, 3)] == seen


def test_published_counts():
    """G_ch 128: 55.9 M entries of state, 59.1 GFLOP an image with the RGB
    head, and one G SA site a call, (B, 4096, 1024, 64, 256)."""
    cfg = manifest.cell(CELL).config_file["config"]
    entries = sum(torch.Size(s).numel() for s, _ in ref.g_spec(cfg).values())
    assert 55.8e6 < entries < 56.0e6
    assert 59.0e9 < work.g_forward(cfg, 1) < 59.3e9
    assert work.sites(cfg, 128) == [("G_SA", (128, 4096, 1024, 64, 256), 1, 0)]
    r = declared(CELL, False)
    assert (r.family, r.unit, r.units_per_call) == ("generate", "images", 128)
    assert r.flops_per_call == work.g_forward(cfg, 128)


TWINS = ("launches_per_call", "device_idle", "mfu", "attn_roofline")


def _traced(cell):
    """A traced run of ``cell`` as its driver declares it, at a small call
    (1 GFLOP, one attention of (1, 64, 16, 64, 256)): two calls in 1 ms,
    one B1 launch in each and a convolution."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": 0, "dur": 1000}]
    for t0 in (0, 500):
        ev += [{"ph": "X", "cat": "user_annotation", "name": "bench.call", "ts": t0, "dur": 500},
               {"ph": "X", "cat": "kernel", "name": "void attention_fwd_kernel<float, 64, 256>(x)",
                "ts": t0 + 100, "dur": 200},
               {"ph": "X", "cat": "kernel", "name": "sm90_xmma_conv", "ts": t0 + 300, "dur": 100}]
    return declared(cell, True, trace=trace.summarize(ev), calls=2, flops_per_call=1e9,
                    attention_sites=[("G_SA", (1, 64, 16, 64, 256), 1, 0)])


@pytest.mark.parametrize("twin", TWINS)
def test_the_sampler_twins_read_what_the_gen_readers_read(twin):
    """Each ``<metric>.sampler`` reads its ``.gen`` twin's quantity in an
    images cell, and nothing in an events cell or an untraced run."""
    mine, events = _traced(CELL), _traced("iea-gan.gen-4ev")
    got = manifest.reader(f"{twin}.sampler").read(mine)
    assert got is not None and got == manifest.reader(f"{twin}.gen").read(mine)
    assert manifest.reader(f"{twin}.sampler").read(events) is None
    assert manifest.reader(f"{twin}.sampler").read(declared(CELL, False)) is None


def test_the_sampler_twins_on_the_synthetic_trace():
    r = _traced(CELL)
    read = {t: manifest.reader(f"{t}.sampler").read(r) for t in TWINS}
    assert read["launches_per_call"] == 2.0
    assert read["device_idle"] == pytest.approx(40.0)          # [100, 400) of each 500
    tf32 = manifest.peaks()["precisions"]["tf32"]
    assert read["mfu"] == pytest.approx(100 * 2e9 / (1e-3 * tf32["flops_per_s"]))
    assert 0 < read["attn_roofline"] < 100


def test_the_entries_only_add():
    """The new cell's entries: one configuration, one cell on one chip,
    ``gen_call_p90_ms`` joined, four new per-layer metrics moving it."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert [c["name"] for c in bench["configs"]][-1] == "biggan-deep-256"
    assert bench["workloads"][-1]["name"] == CELL and bench["workloads"][-1]["chips"] == 1
    joined = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]
              if CELL in m.get("workloads", [])]
    assert joined == ["gen_call_p90_ms"] + [f"{t}.sampler" for t in TWINS]
    assert all(m["moves"] == "gen_call_p90_ms" and m["source"] == "device_trace"
               for m in bench["per_layer"][-len(TWINS):])
