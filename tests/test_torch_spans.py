"""The port's spans (``ieagan_torch/core/spans.py``): off, no span enters
``record_function``; under a profiler, one train step's trace holds the
step's tree, one ``ieagan.sn`` per spectral-norm forward and the attention
spans of every site the tiny config builds; a generator call is one
``ieagan.gen.call``, whose SN layers run the power iteration on the first
call and reuse W/σ (``ieagan.sn.cached``) on the next; the loader's wait is
one ``ieagan.data.wait`` a batch."""

import numpy as np
import pytest
import torch

from ieagan_torch.core import spans
from ieagan_torch.data.pipeline import EventLoader
from ieagan_torch.deploy.inference import Model, generate_batched
from ieagan_torch.models.discriminator import Discriminator
from ieagan_torch.models.generator import Generator
from ieagan_torch.ops.spectral import _SpectralNorm
from ieagan_torch.train.step import init_train_state, make_train_step
from tests.helpers import tiny_config
from tests.test_torch_eval import few_torch_threads  # noqa: F401 (module fixture)

# the fused route (B1/B2's plain versions on the CPU, through FlashAttention)
# and G's SA at 16, so that every site has a forward and a backward span
CFG = tiny_config(use_pallas_attention=True, G_attn="16")
SITES = ("rr_g", "g_sa", "rr_d", "d_sa")


def _state(seed=0):
    G, D = Generator.from_config(CFG), Discriminator.from_config(CFG)
    return init_train_state(G, D, CFG, torch.Generator().manual_seed(seed))


def _batch():
    g = torch.Generator().manual_seed(1)
    b = CFG["n_classes"] * CFG["events_per_batch"]
    x = torch.rand((b, CFG["resolution"], CFG["resolution"], 1), generator=g) * 2 - 1
    y = torch.arange(CFG["n_classes"]).repeat(CFG["events_per_batch"])
    return x, y


def test_off_path_never_enters_record_function(monkeypatch):
    """No profiler: a G forward, ``generate_batched`` and a train step run
    with the ``record_function`` that the spans call made to raise."""
    def boom(name):
        raise AssertionError(f"span {name!r} entered record_function with no profiler")

    monkeypatch.setattr(spans, "record_function", boom)
    assert not torch.autograd.profiler._is_profiler_enabled
    state = _state()
    x, y = _batch()
    z = torch.randn((x.shape[0], CFG["dim_z"]))
    with torch.no_grad():
        assert state.G(z, y, torch.randn((x.shape[0], CFG["rdof_dim"]))).shape == x.shape
    model = Model(config=CFG, device="cpu")
    assert generate_batched(model, 1, torch.Generator().manual_seed(2)).shape[0] == CFG["n_classes"]
    mets = make_train_step(state.G, state.D, CFG)(state, x, y, torch.Generator().manual_seed(3))
    assert set(mets) >= {"D_loss_real", "G_loss"}


def test_traced_step_holds_the_span_tree():
    state = _state()
    x, y = _batch()
    forwards = {"G": 0, "D": 0}
    for net in ("G", "D"):
        for m in getattr(state, net).modules():
            if isinstance(m, _SpectralNorm):
                m.register_forward_hook(
                    lambda *_, net=net: forwards.__setitem__(net, forwards[net] + 1))
    sn_layers = {net: sum(isinstance(m, _SpectralNorm) for m in getattr(state, net).modules())
                 for net in ("G", "D")}
    step = make_train_step(state.G, state.D, CFG)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(state, x, y, torch.Generator().manual_seed(3))
    names = [e.name for e in prof.events() if e.name.startswith("ieagan.")]
    count = lambda name: names.count(name)
    for name in ("step", "d_phase", "g_phase", "d_forward", "d_backward", "g_forward",
                 "g_backward", "ema", "wait"):
        assert count(f"ieagan.train.{name}") == 1, name
    assert count("ieagan.train.update") == 2
    # G runs twice a step (the D phase's no-grad pass, the G phase), D three
    # times (split D: fakes, reals; the G phase's pass)
    assert forwards == {"G": 2 * sn_layers["G"], "D": 3 * sn_layers["D"]}
    assert count("ieagan.sn") == forwards["G"] + forwards["D"]
    for site in SITES:
        assert count(f"ieagan.attn.{site}") >= 1, site
        assert count(f"ieagan.attn.{site}.bwd") >= 1, site
    assert {n for n in names if n.startswith("ieagan.attn")} == (
        {f"ieagan.attn.{s}" for s in SITES} | {f"ieagan.attn.{s}.bwd" for s in SITES})


@pytest.mark.parametrize("fused", [False, True])
def test_generator_call_span(fused):
    """``generate_batched`` is one ``ieagan.gen.call`` holding G's SN and
    attention spans, by either attention route. The first call runs every SN
    layer's power iteration (``ieagan.sn``); the second reuses every W/σ
    (``ieagan.sn.cached``): a hit share of 1."""
    model = Model(config=dict(CFG, use_pallas_attention=fused), device="cpu")
    n_sn = sum(isinstance(m, _SpectralNorm) for m in model.G.modules())
    for call, (misses, hits) in enumerate([(n_sn, 0), (0, n_sn)]):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            generate_batched(model, 1, torch.Generator().manual_seed(2 + call))
        names = [e.name for e in prof.events() if e.name.startswith("ieagan.")]
        assert names.count("ieagan.gen.call") == 1
        assert (names.count("ieagan.sn"), names.count("ieagan.sn.cached")) == (misses, hits)
        assert hits / (hits + misses) == call
        assert sorted(n for n in names if n.startswith("ieagan.attn")) == [
            "ieagan.attn.g_sa", "ieagan.attn.rr_g"]


class _Events:
    """Four events of two 8x8 images each."""

    def __len__(self):
        return 4

    def __getitem__(self, i):
        return np.full((2, 8, 8, 1), i, np.float32), np.arange(2, dtype=np.int32)


def test_loader_wait_span(monkeypatch):
    """Each batch the consumer takes is one ``ieagan.data.wait``; with no
    profiler the loader never enters ``record_function``."""
    loader = EventLoader(_Events(), num_workers=1, shuffle=False, events_per_batch=2)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert len(list(loader)) == 2
    # two batches and the end of the epoch
    assert [e.name for e in prof.events()].count("ieagan.data.wait") == 3
    monkeypatch.setattr(spans, "record_function", lambda name: 1 / 0)
    assert len(list(loader)) == 2
