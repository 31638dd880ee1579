"""Why fused and plain attention give train-step gradients apart by far more
than the attention's rounding: amplification by the step, or a fault of the
fused path?

On the CPU the fused attention (``FlashAttention``) runs B1's and B2's plain
versions, which round differently from the plain composition
(``dot_softmax_attention(fused=False)``). One tiny train step (the config of
``tests/test_torch_train_step.py``, the port alone, seeded weights and
draws) is taken from the same state:

  * plain, twice: the CPU's noise floor (the step is deterministic here);
  * fused: the gap in question;
  * plain with RR_G's attention output (the input of its ``o_proj``, both G
    passes) multiplied by 1 + eps * r, r = +-1 seeded, eps the largest
    relative fused-vs-plain difference of any attention output;
  * plain with every attention output (RR_G, RR_D, D's image attention)
    perturbed the same way.

If the fused gap were a fault it would stand apart from the perturbations'.
It does not: fused and all-sites-perturbed have the same size, module by
module. Run as a script to print the table:

    PYTHONPATH=. python tests/test_torch_step_sensitivity.py
"""

import numpy as np
import pytest
import torch

from ieagan_torch.models.discriminator import Discriminator
from ieagan_torch.ops import attention as attention_ops
from ieagan_torch.ops import rrm
from ieagan_torch.models.generator import Generator
from ieagan_torch.ops.diff_aug import sample_diff_aug_draws
from ieagan_torch.train.step import init_train_state, make_train_step
from tests.helpers import tiny_config
from tests.test_torch_eval import few_torch_threads  # noqa: F401 (autouse fixture)

SEED = 3


def _config(fused: bool) -> dict:
    return tiny_config(RRM_prx_G=True, rdof_dim=4, diff_aug=True, use_pallas_attention=fused,
                       compute_dtype="float32")


def _state_dicts():
    """Seeded weights with every leaf live: SA gammas (zero at init) and
    biases made nonzero, so that D's image attention feeds the losses."""
    gen = torch.Generator().manual_seed(SEED)
    cfg = _config(False)
    G, D = Generator.from_config(cfg), Discriminator.from_config(cfg)
    init_train_state(G, D, cfg, gen)
    for module in (G, D):
        for name, p in module.named_parameters():
            if name.endswith("gamma") or name.endswith("bias"):
                with torch.no_grad():
                    p.copy_(0.3 * torch.randn(p.shape, generator=gen))
    return ({k: v.clone() for k, v in G.state_dict().items()},
            {k: v.clone() for k, v in D.state_dict().items()})


def _inputs(cfg):
    gen = torch.Generator().manual_seed(SEED + 1)
    es, epb, res = cfg["n_classes"], cfg["events_per_batch"], cfg["resolution"]
    b = es * epb
    x = torch.rand((b, res, res, 1), generator=gen) * 2 - 1
    y = torch.arange(es).repeat(epb)
    draw = lambda n: torch.randn((b, n), generator=gen)
    aug = lambda: sample_diff_aug_draws(gen, b, res, res, cfg["diff_aug_policy"])
    schedule = [draw(cfg["dim_z"]), draw(4), aug(), aug(), draw(cfg["dim_z"]), draw(4), aug()]
    return x, y, schedule


def run_step(fused: bool, perturb=None, sites="all"):
    """One step from the seeded state; returns (metrics, gradients by
    'G.<leaf>'/'D.<leaf>', every attention output in call order).
    ``perturb``: a relative size by which the attention outputs of ``sites``
    ("RR_G" or "all") are perturbed, as 1 + perturb * r, r = +-1 seeded."""
    cfg = _config(fused)
    G, D = Generator.from_config(cfg), Discriminator.from_config(cfg)
    state = init_train_state(G, D, cfg)  # fresh Adam; the weights come next
    g_sd, d_sd = _state_dicts()
    G.load_state_dict(g_sd)
    D.load_state_dict(d_sd)
    x, y, schedule = _inputs(cfg)
    outputs = []
    sign = torch.Generator().manual_seed(SEED + 2)
    noise = lambda a: 1 + perturb * (torch.randint(0, 2, a.shape, generator=sign) * 2 - 1)
    original = attention_ops.dot_softmax_attention

    def attend(q, k, v, scale=1.0, fused=False):
        o = original(q, k, v, scale=scale, fused=fused)
        outputs.append(o.detach().clone())
        return o * noise(o) if perturb is not None and sites == "all" else o

    def rr_g_hook(module, args):
        return (args[0] * noise(args[0]),)

    handle = (G.RR_G.layers_0.self_attn.o_proj.register_forward_pre_hook(rr_g_hook)
              if perturb is not None and sites == "RR_G" else None)
    mp = pytest.MonkeyPatch()
    mp.setattr(attention_ops, "dot_softmax_attention", attend)
    mp.setattr(rrm, "dot_softmax_attention", attend)
    try:
        m = make_train_step(G, D, cfg, draw_schedule=schedule, capture_grads=True)(state, x, y)
    finally:
        mp.undo()
        if handle is not None:
            handle.remove()
    grads = {**{f"G.{k}": v for k, v in m["_grads_G"].items()},
             **{f"D.{k}": v for k, v in m["_grads_D"].items()}}
    metrics = {k: v for k, v in m.items() if not k.startswith("_")}
    return metrics, grads, outputs


def attention_difference(fused, plain) -> float:
    """The largest relative difference of an attention output, fused
    against plain, over every call of the step."""
    assert len(fused[2]) == len(plain[2]) > 0
    return max(float((f - p).norm() / p.norm()) for f, p in zip(fused[2], plain[2]))


def leaf_errors(got: dict, want: dict) -> dict:
    """Per leaf ||got - want|| / ||want|| (leaves null in exact arithmetic,
    norm < 1e-5, left out)."""
    out = {}
    for name, w in want.items():
        w, g = w.double(), got[name].double()
        if float(w.norm()) >= 1e-5:
            out[name] = float((g - w).norm() / w.norm())
    return out


def module_gaps(got: dict, want: dict) -> dict:
    """||got - want|| / ||want|| over the leaves of each top-level module
    ('G.blocks_2_1', 'G.linear_f', 'D.attn_2', ...)."""
    groups = {}
    for name, w in want.items():
        key = ".".join(name.split(".")[:2])
        d, n = groups.get(key, (0.0, 0.0))
        groups[key] = (d + float((got[name].double() - w.double()).norm() ** 2),
                       n + float(w.double().norm() ** 2))
    return {k: (d / n) ** 0.5 if n > 0 else 0.0 for k, (d, n) in groups.items()}


def all_runs():
    plain, fused = run_step(False), run_step(True)
    eps = attention_difference(fused, plain)
    return {"plain": plain, "plain again": run_step(False), "fused": fused, "eps": eps,
            "RR_G perturbed": run_step(False, eps, "RR_G"),
            "all perturbed": run_step(False, eps, "all")}


@pytest.fixture(scope="module")
def runs():
    return all_runs()


def test_the_step_is_deterministic_on_the_cpu(runs):
    a, b = runs["plain"], runs["plain again"]
    assert a[0] == b[0]
    assert all(torch.equal(a[1][k], b[1][k]) for k in a[1])


def test_fused_attention_differs_from_plain_by_rounding_only(runs):
    """Every attention output, fused against plain: f32 rounding (~1e-7)."""
    assert 0 < runs["eps"] < 1e-6


def test_the_fused_gap_is_the_steps_amplification_of_rounding(runs):
    """Fused against plain, and plain against rounding-sized perturbations of
    every attention output: per-leaf max and median within a factor of 10
    of each other, no module where the fused gap stands apart by more than
    30x, both inside the step's tolerance. The RR_G perturbation alone moves
    G's modules as much as fused attention does."""
    want = runs["plain"][1]
    fused, perturbed = (leaf_errors(runs[k][1], want) for k in ("fused", "all perturbed"))
    for errs in (fused, perturbed):
        assert max(errs.values()) < 1e-2 and np.median(list(errs.values())) < 1e-3
    for stat in (max, np.median):
        ratio = stat(list(fused.values())) / stat(list(perturbed.values()))
        assert 0.1 < ratio < 10, (stat.__name__, ratio)
    gap_f = module_gaps(runs["fused"][1], want)
    for label, modules in (("all perturbed", gap_f), ("RR_G perturbed",
                                                      [k for k in gap_f if k.startswith("G.")])):
        gap_p = module_gaps(runs[label][1], want)
        floor = 1e-3 * max(gap_p.values())
        apart = {k: gap_f[k] / max(gap_p[k], floor) for k in modules if gap_f[k] > floor}
        assert max(apart.values()) < 30, (label, sorted(apart.items(), key=lambda kv: -kv[1])[:5])


def main():
    runs = all_runs()
    plain = runs["plain"]
    print(f"attention outputs, fused vs plain: max relative difference {runs['eps']:.3e} "
          f"over {len(plain[2])} calls (the perturbations' size)")
    labels = ("fused", "RR_G perturbed", "all perturbed")
    for label in labels:
        run = runs[label]
        errs = leaf_errors(run[1], plain[1])
        m_rel = max(abs(run[0][k] - plain[0][k]) / max(abs(plain[0][k]), 1e-12) for k in plain[0])
        worst = [(k, f"{v:.2e}") for k, v in sorted(errs.items(), key=lambda kv: -kv[1])[:3]]
        print(f"{label} vs plain: metrics max rel {m_rel:.3e}; per-leaf max "
              f"{max(errs.values()):.3e}, median {np.median(list(errs.values())):.3e}; "
              f"worst {worst}")
    gaps = {label: module_gaps(runs[label][1], plain[1]) for label in labels}
    print(f"{'module':16s}" + "".join(f"{label:>16s}" for label in labels))
    for k in sorted(gaps["fused"], key=lambda k: -gaps["fused"][k]):
        print(f"{k:16s}" + "".join(f"{gaps[label][k]:16.3e}" for label in labels))


if __name__ == "__main__":
    main()
