"""GAN -> PXDDigits production from a generator checkpoint (twin of
``physics_analysis/create_gan_digits.py``; reference:
Physics_Analysis/create_g1.py).

    python -m ieagan_torch.deploy.create_gan_digits <output> <num_events> \\
        [--checkpoint <weights dir or G*.msgpack>] [--tag best0] \\
        [--config cfg.json] [--events-per-call 4] [--seed 0]

Generates events with ``deploy/producer.py::produce_events``: into a basf2
``RootOutput`` loop when basf2 is importable, else npz shards under
``<output>``. A checkpoint is resolved as the JAX package resolves it (a
weights dir's newest copy tag, or ``--tag``, G_ema before G; a file as it
is), and the resolved file's sha256 is printed before it is loaded. Runs on
the GPU; ``IEAGAN_PLATFORM=cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os


def file_sha256(path: str) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as fp:
        for block in iter(lambda: fp.read(1 << 20), b""):
            digest.update(block)
    return digest.hexdigest()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("output", type=str)
    ap.add_argument("num_events", type=int)
    ap.add_argument("--checkpoint", type=str, default=None,
                    help="weights dir (driver layout) or a G*.msgpack file")
    ap.add_argument("--tag", type=str, default=None,
                    help="checkpoint tag (e.g. copy12000, best0); default: the newest copy tag "
                         "in the weights dir")
    ap.add_argument("--config", type=str, default=None,
                    help="JSON file of model-config overrides (a driver run's dumped config "
                         "works)")
    ap.add_argument("--events-per-call", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    config = None
    if args.config:
        with open(args.config, encoding="utf-8") as fp:
            config = json.load(fp)

    from ieagan_torch.deploy.inference import Model
    from ieagan_torch.deploy.producer import produce_events
    from ieagan_torch.train.cli import tool_device
    from ieagan_torch.utils.flax_msgpack import resolve_generator_checkpoint

    device = tool_device()
    if args.checkpoint:
        resolved = resolve_generator_checkpoint(args.checkpoint, tag=args.tag)
        # the file actually loaded (reference: create_g1.py:173-178)
        print(f"checkpoint {os.path.basename(resolved)} sha256: {file_sha256(resolved)}",
              flush=True)
        model = Model.restore(resolved, config=config, device=device)
    else:
        model = Model(config=config, device=device)

    n = produce_events(model, args.num_events, out_dir=args.output,
                       events_per_call=args.events_per_call, seed=args.seed)
    print(f"produced {n} events -> {args.output}", flush=True)
    return n


if __name__ == "__main__":
    main()
