"""The eval spectral norm's kept W/σ (``ops/spectral.py::_SpectralNorm``):
an eval call with grad off reuses the W/σ of the call before it, bit for
bit, until ``weight`` or ``u`` changes in any way the module can see; an
eval call with grad on, a train-mode call and a recompute run the power
iteration as before."""

import copy

import pytest
import torch

from ieagan_torch.deploy.inference import Model, generate_batched
from ieagan_torch.models.generator import Generator
from ieagan_torch.ops.spectral import _SpectralNorm
from ieagan_torch.train.step import update_ema
from tests.helpers import tiny_config
from tests.test_torch_eval import few_torch_threads  # noqa: F401 (module fixture)

CFG = tiny_config(G_attn="16")


def _sn_layers(G):
    return [m for m in G.modules() if isinstance(m, _SpectralNorm)]


def _generator(seed):
    G = Generator.from_config(CFG)
    G.reset_parameters(torch.Generator().manual_seed(seed))
    return G.eval()


def _latents():
    g = torch.Generator().manual_seed(5)
    n = CFG["n_classes"]
    z = torch.randn((n, CFG["dim_z"]), generator=g)
    rdof = torch.randn((n, CFG["rdof_dim"]), generator=g)
    return z, torch.arange(n), rdof


def _run(G):
    with torch.inference_mode():
        return G(*_latents())


def _outputs(G):
    """Every SN layer's W/σ and, for a float32 ``G`` (the generator's layer
    norms do not run in float64 on the CPU), its images."""
    with torch.inference_mode():
        out = [m.normalized_weight() for m in _sn_layers(G)]
        if next(G.parameters()).dtype == torch.float32:
            out.append(G(*_latents()))
    return out


def _fresh(G):
    """A generator built anew, with ``G``'s state dict and no kept W/σ."""
    H = Generator.from_config(CFG).to(next(G.parameters()).dtype)
    H.load_state_dict(G.state_dict())
    return H.eval()


def test_reuse_is_bit_equal_to_the_power_iteration():
    """Two calls on one eval ``Model``: the second reuses every layer's W/σ
    and gives what a copy's first call, which runs the iteration, gives."""
    model = Model(config=CFG, device="cpu")
    copy_ = copy.deepcopy(model)
    first = generate_batched(model, 1, torch.Generator().manual_seed(2))
    kept = [m._sn_cache[2] for m in _sn_layers(model.G)]
    second = generate_batched(model, 1, torch.Generator().manual_seed(3))
    assert all(m._sn_cache[2] is k for m, k in zip(_sn_layers(model.G), kept))
    assert torch.equal(second, generate_batched(copy_, 1, torch.Generator().manual_seed(3)))
    assert torch.equal(first, generate_batched(copy_, 1, torch.Generator().manual_seed(2)))


def _mul_weight(G):
    w = _sn_layers(G)[1].weight
    with torch.no_grad():
        w.mul_(1 + torch.rand(w.shape, generator=torch.Generator().manual_seed(7)))


def _new_u(G):
    with torch.no_grad():
        for m in _sn_layers(G):
            m.u.normal_(generator=torch.Generator().manual_seed(7))


def _load_state_dict(G):
    G.load_state_dict(_generator(1).state_dict())


def _update_ema(G):
    with torch.no_grad():
        update_ema(G, _generator(1), 0.5)


def _assign_data(G):
    w = _sn_layers(G)[1].weight
    w.data = w.data + torch.randn(w.shape, generator=torch.Generator().manual_seed(7))


def _to_float64(G):
    G.to(torch.float64)
    assert all(m._sn_cache is None for m in _sn_layers(G))


def _train_then_eval(G):
    G.train()
    assert all(m._sn_cache is None for m in _sn_layers(G))
    G.eval()


@pytest.mark.parametrize("change", [_mul_weight, _new_u, _load_state_dict, _update_ema,
                                    _assign_data, _to_float64, _train_then_eval],
                         ids=lambda f: f.__name__.lstrip("_"))
def test_a_change_to_weight_or_u_is_seen(change):
    G = _generator(0)
    before = _outputs(G)
    _outputs(G)
    change(G)
    after = _outputs(G)
    want = _outputs(_fresh(G))
    assert len(after) == len(want)
    for got, ref in zip(after, want):
        assert got.dtype == ref.dtype and torch.equal(got, ref)
    if change not in (_to_float64, _train_then_eval):
        assert not all(torch.equal(a, b) for a, b in zip(after, before))


def test_eval_with_grad_on_runs_the_iteration():
    """An eval forward that records autograd does not take the kept W/σ (an
    inference tensor, here), and its gradients are the uncached ones."""
    G = _generator(0)
    plain = copy.deepcopy(G)
    _run(G)
    grads = []
    for net in (G, plain):
        z, y, rdof = _latents()
        z.requires_grad_(True)
        net(z, y, rdof).square().sum().backward()
        grads.append([z.grad] + [p.grad for p in net.parameters()])
    for got, want in zip(*grads):
        assert (got is None) == (want is None)
        assert got is None or torch.equal(got, want)


@pytest.mark.parametrize("grad", [False, True])
def test_train_mode_advances_u_and_keeps_nothing(grad):
    G = _generator(0)
    _run(G)
    G.train()
    layer = _sn_layers(G)[0]
    for _ in range(2):
        u = layer.u.clone()
        with torch.set_grad_enabled(grad):
            G(*_latents())
        assert not torch.equal(layer.u, u)
        assert all(m._sn_cache is None for m in _sn_layers(G))
