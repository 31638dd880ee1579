"""Model comparison by physics observables (twin of ``scripts/eval_all.py``;
reference: Evaluation/eval_all.py): the intensity, occupancy and mean-charge
statistics of ``eval/physics.py`` for trained generators (IEA-GAN and the
paper's comparison models) and, optionally, the real dataset, pickled for
plotting.

    python -m ieagan_torch.eval.compare --out eval_results.pickle \\
        --model IEAGAN:<run dir> --model PEGAN:<model.pth> [--dataroot <data>] \\
        [--n-events 100] [--host-stats] [--device cpu] [--config overrides.json]

Each ``NAME:path`` is a run dir of either package's driver (its newest copy
tag, G_ema first), a single ``G*.msgpack`` file, or a reference-layout
``.pth``/``.pt`` state dict, built with ``ABLATION_OVERRIDES[NAME]`` and then
the ``--config`` JSON overrides on top of the frozen deployment config. The
pickle maps ``"real"`` and each model's name to the stats dict of
``eval/physics.py`` (the keys of ``scripts/eval_all.py:76-101``). Statistics
are reduced on the device by default; ``--host-stats`` pulls every event to
the host instead.
"""

from __future__ import annotations

import argparse
import json
import pickle

from ieagan_torch.deploy.inference import Model
from ieagan_torch.eval import physics

# The comparison models (reference: Evaluation/eval_all.py:23-72): ContraGAN
# has no RRM and no rdof; PEGAN adds G attention at 32; BigGAN_deep is
# ContraGAN's generator.
ABLATION_OVERRIDES = {
    "IEAGAN": {},
    "ContraGAN": {"RRM_prx_G": False, "rdof_dim": 0},
    "PEGAN": {"G_attn": "32", "RRM_prx_G": False, "rdof_dim": 0},
    "BigGAN_deep": {"RRM_prx_G": False, "rdof_dim": 0},
}


def load_model(name: str, weights: str, config: dict | None = None,
               device="cuda") -> Model:
    """Model ``name`` (its ``ABLATION_OVERRIDES``, then ``config``) from a
    run dir or ``G*.msgpack`` through ``Model.restore``, or from a ``.pth``
    or ``.pt`` through ``Model.from_torch``."""
    overrides = dict(ABLATION_OVERRIDES.get(name, {}))
    overrides.update(config or {})
    if weights.endswith((".pth", ".pt")):
        return Model.from_torch(weights, config=overrides, device=device)
    return Model.restore(weights, config=overrides, device=device)


def compare(specs: list[str], n_events: int = 100, seed: int = 0,
            dataroot: str | None = None, n_events_real: int | None = None,
            host_stats: bool = False, device="cuda", config: dict | None = None) -> dict:
    """Stats per ``NAME:path`` in ``specs`` (each model built with
    ``config`` over its ablation's overrides) and, with ``dataroot``, for the
    real dataset under ``"real"``."""
    all_stats = {}
    if dataroot:
        all_stats["real"] = physics.get_stats(physics.real_event_stream(dataroot, seed),
                                              n_events_real or n_events)
    for spec in specs:
        name, _, weights = spec.partition(":")
        model = load_model(name, weights, config, device=device)
        if host_stats:
            all_stats[name] = physics.get_stats(
                physics.generate_event_stream(model.G, model.config, seed), n_events)
        else:
            all_stats[name] = physics.generate_stats(model.G, model.config, n_events, seed)
        print(f"{name}: occupancy mean {all_stats[name]['per_sensor_occupancy'].mean():.5f}",
              flush=True)
    return all_stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="eval_results.pickle")
    ap.add_argument("--model", action="append", default=[],
                    help="NAME:weights (a run dir, G*.msgpack or .pth; repeatable)")
    ap.add_argument("--dataroot", default=None)
    ap.add_argument("--n-events", type=int, default=100,
                    help="generated events per model (reference scale: 10k)")
    ap.add_argument("--n-events-real", type=int, default=None,
                    help="real events (default: --n-events)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--host-stats", action="store_true",
                    help="accumulate the stats on the host from whole events")
    ap.add_argument("--config", default=None,
                    help="a JSON file of config overrides for every model")
    args = ap.parse_args(argv)
    config = None
    if args.config:
        with open(args.config) as fp:
            config = json.load(fp)
    stats = compare(args.model, args.n_events, args.seed, args.dataroot,
                    args.n_events_real, args.host_stats, args.device, config)
    with open(args.out, "wb") as fp:
        pickle.dump(stats, fp)
    print(f"stats -> {args.out}")


if __name__ == "__main__":
    main()
