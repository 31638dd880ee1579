"""The plain reference against the port at a tiny width, on the CPU: the
generator in eval and train mode, the discriminator, and whole train steps
through the harness's own driver with the program in float32."""

import pytest
import torch

from benchmark import run as bench_run
from benchmark.harness import manifest, weights
from benchmark.reference import model as ref

TINY = dict(resolution=64, G_ch=8, D_ch=8, H_base=2, n_classes=4, hypersphere_dim=64)


def config_file(name):
    return manifest.load_json(manifest.HERE / "configs" / f"{name}.json")


def tiny_config(name, **extra):
    from ieagan_torch.core.config import DEFAULT_CONFIG
    return {**DEFAULT_CONFIG, **config_file(name)["config"], **TINY, **extra}


def port(cfg, S, cls):
    m = cls.from_config(cfg)
    m.load_state_dict(S, strict=True)
    return m


@pytest.mark.parametrize("name", ["iea-gan", "pegan"])
@pytest.mark.parametrize("train", [False, True])
def test_generator(name, train):
    from ieagan_torch.models.generator import Generator
    cfg = tiny_config(name, use_pallas_attention=True)
    S = weights.make(ref.g_spec(cfg), 3, torch.device("cpu"))
    G = port(cfg, S, Generator).train(train)
    b = 2 * cfg["n_classes"]
    gen = torch.Generator().manual_seed(5)
    z, rdof = torch.randn(b, 128, generator=gen), torch.randn(b, cfg["rdof_dim"], generator=gen)
    y = torch.arange(cfg["n_classes"]).repeat(2)
    with torch.no_grad():
        want = G(z, y, rdof)
    S_ref = dict(S)
    got = ref.generator(cfg, S_ref, z, y, rdof, ref.Ops(), train=train)
    assert torch.allclose(got, want, atol=2e-5, rtol=0)
    state = G.state_dict()
    for k in S_ref:
        if k.endswith((".u", ".sv")):
            assert torch.allclose(S_ref[k], state[k], atol=1e-5), k


def test_discriminator():
    from ieagan_torch.models.discriminator import Discriminator
    cfg = tiny_config("iea-gan", use_pallas_attention=True)
    S = weights.make(ref.d_spec(cfg), 4, torch.device("cpu"))
    D = port(cfg, S, Discriminator).train()
    b = 2 * cfg["n_classes"]
    x = torch.rand((b, 64, 128, 1), generator=torch.Generator().manual_seed(6)) * 2 - 1
    y = torch.randperm(cfg["n_classes"]).repeat(2)
    with torch.no_grad():
        want = D(x, y)
    S_ref = dict(S)
    got = ref.discriminator(cfg, S_ref, x, y, ref.Ops())
    for g, w in zip(got, want):
        assert torch.allclose(g, w, atol=1e-5, rtol=1e-5)
    state = D.state_dict()
    for k in S_ref:
        if k.endswith(".u"):
            assert torch.allclose(S_ref[k], state[k], atol=1e-5), k


@pytest.mark.parametrize("name", ["iea-gan", "pegan"])
def test_train_steps_in_float32(name):
    """The harness's train traffic with the program in float32: the three
    checked steps agree with the reference's to rounding. Sums run in
    another order on each side; at a tiny width, float32 rounding moves a
    leaf's gradient norm by up to ~1e-3 and, through Adam's first steps
    (g / (|g| + eps) for gradients near eps), its update by a few 1e-3 (the
    program in bfloat16 reads ~2e-2 to 4e-2)."""
    c = manifest.cell("iea-gan.train-3ev")
    c.config_file, c.config_name = config_file(name), name
    cfg = tiny_config(name, compute_dtype="float32")
    run = bench_run.measure(c, 2 ** 31 + 11, 0.1, False, torch.device("cpu"), config=cfg)
    values = {ch.name: ch.value for ch in run.checks}
    values.update(run.notes["not compared"])
    assert values["loss_gap"] < 1e-4
    assert values["grad_gap"] < 5e-3
    assert values["update_gap"] < 1e-2

