"""The control of a cell's comparison, on the card at the cell's own size:

    python3 benchmark/control.py --workload <cell> --seed <n> [--seconds <s>]

drives the cell as ``run.py`` does with the plain reference, computed at the
cell's ``control`` precision (``workloads/<cell>.json``: bfloat16 below
float32 with TF32, float8 below bfloat16), in the program's place, and
prints one JSON line with each compared number beside its limit. A sound
comparison reads ``correct`` false here. The benchmark's own runs never run
this. ``--fault <name>`` runs the program with that fault planted in its
timed path instead (``traffic/<kind>.py``), which has to read false too.
"""

from __future__ import annotations

import argparse
import json
import sys

from run import STARTED, measure, use_checkout_caches


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--fault", default=None,
                        help="plant this fault in the program instead (traffic/<kind>.py)")
    args = parser.parse_args(argv)
    use_checkout_caches()
    from benchmark.harness import manifest
    cell = manifest.cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    mode = "program" if args.fault else "control"
    run = measure(cell, args.seed, args.seconds, False, torch.device("cuda", 0),
                  mode=mode, fault=args.fault, started=STARTED)
    print(json.dumps({"workload": cell.name, "seed": args.seed, "mode": mode,
                      "fault": args.fault, "precision": cell.workload["control"],
                      "correct": run.correct,
                      "notes": run.notes,
                      "checks": {c.name: {"value": c.value, "limit": c.limit}
                                 for c in run.checks}}, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
