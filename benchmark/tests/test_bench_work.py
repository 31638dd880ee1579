"""The work counters: model FLOPs from shapes against
``torch.utils.flop_counter.FlopCounterMode`` over the port's G and D at a
small resolution, and the attention sites against the shapes the port's
attention is called with."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import manifest
from benchmark.work import attention, model_flops

SMALL = dict(resolution=64, G_ch=8, D_ch=8, H_base=2, n_classes=4, hypersphere_dim=64,
             use_pallas_attention=False)
CONFIGS = {"iea-gan": {}, "pegan": {"G_attn": "32", "RRM_prx_G": False, "rdof_dim": 0}}


def small_config(name):
    from ieagan_torch.core.config import DEFAULT_CONFIG
    return {**DEFAULT_CONFIG, **manifest.cell(f"{name}.gen-4ev").config_file["config"],
            **SMALL}


def port_models(cfg):
    from ieagan_torch.models.discriminator import Discriminator
    from ieagan_torch.models.generator import Generator
    G, D = Generator.from_config(cfg), Discriminator.from_config(cfg)
    G.reset_parameters(torch.Generator().manual_seed(0))
    D.reset_parameters(torch.Generator().manual_seed(1))
    return G, D


def counted(fn):
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        out = fn()
    return fc.get_total_flops(), out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_flops_match_the_counter(name):
    cfg = small_config(name)
    G, D = port_models(cfg)
    b = 2 * cfg["n_classes"]
    z = torch.randn(b, cfg["dim_z"])
    y = torch.arange(cfg["n_classes"]).repeat(2)
    rdof = torch.randn(b, cfg["rdof_dim"])
    g_count, img = counted(lambda: G(z, y, rdof))
    d_count, _ = counted(lambda: D(img, y))
    # the counter sees the same products; the singular value's einsum of a
    # one-row matrix is counted without its last 2 o additions
    assert model_flops.g_forward(cfg, b) == pytest.approx(g_count, rel=1e-4)
    assert model_flops.d_forward(cfg, b) == pytest.approx(d_count, rel=1e-4)


def test_flagship_counts():
    """The published widths: G about 10 GFLOP an image."""
    cfg = {k: v for k, v in small_config("iea-gan").items()}
    cfg.update(resolution=256, G_ch=32, D_ch=32, H_base=3, n_classes=40, hypersphere_dim=1024)
    assert 9.5e9 < model_flops.g_forward(cfg, 1) < 10.5e9
    assert 15e12 < model_flops.train_step(cfg, 3) < 18e12


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_attention_sites_are_the_calls_the_model_makes(name, monkeypatch):
    """Every attention the port computes in a generator call at the
    flagship's site rule, shape for shape (small widths, full rule)."""
    import ieagan_torch.ops.attention as att
    import ieagan_torch.ops.rrm as rrm
    cfg = small_config(name)
    cfg.update(resolution=256, H_base=1, G_ch=8, n_classes=4)
    seen = []
    plain = att.dot_softmax_attention

    def spy(q, k, v, scale=1.0, fused=False):
        seen.append((q.reshape(-1, *q.shape[-2:]).shape[0], q.shape[-2], k.shape[-2],
                     q.shape[-1], v.shape[-1]))
        return plain(q, k, v, scale, fused)

    monkeypatch.setattr(att, "dot_softmax_attention", spy)
    monkeypatch.setattr(rrm, "dot_softmax_attention", spy)
    from ieagan_torch.models.generator import Generator
    G = Generator.from_config(cfg)
    G.reset_parameters(torch.Generator().manual_seed(0))
    events = 2
    b = events * cfg["n_classes"]
    with torch.no_grad():
        G(torch.randn(b, 128), torch.arange(cfg["n_classes"]).repeat(events),
          torch.randn(b, cfg["rdof_dim"]))
    want = [shape for _, shape, n_fwd, _ in attention.sites(cfg, "generate", events)
            for _ in range(n_fwd)]
    assert sorted(seen) == sorted(want)


def test_least_time_is_the_larger_bound():
    shape = (40, 3072, 768, 32, 128)
    nbytes, flops = attention.fwd_work(*shape, 2)
    t = attention.least_seconds([("D_SA", shape, 1, 0)], 2, 989e12, 3.35e12)
    assert t == max(flops / 989e12, nbytes / 3.35e12)
    assert flops == 2.0 * 40 * 3072 * 768 * (32 + 128)
