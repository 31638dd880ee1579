"""Mint FID (mu/sigma) and KID (raw feature) reference statistics from a
folder of real images (twin of ``scripts/mint_stats.py``; reference:
mycleanfid/fid.py:832-867).

    python -m ieagan_torch.eval.mint_stats <name> <real_dir> [--num 16000] \\
        [--mode clean] [--no-kid] [--overwrite] [--host-resize] [--cpu]

Writes ``<name>_<mode>_custom_na.npz`` (and ``..._kid.npz``) under
``$IEAGAN_STATS_DIR`` (default ``stats/``) with ``default_extractor()``: the
PXD backbone ``inception_pxd.msgpack`` there when it exists, else the seeded
fallback; its source goes to stderr. Images are resized on the device unless
``--host-resize`` asks for PIL on the host. Runs on the GPU unless ``--cpu``
or ``IEAGAN_PLATFORM=cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("name")
    ap.add_argument("real_dir")
    ap.add_argument("--num", type=int, default=16000)
    ap.add_argument("--mode", default="clean")
    ap.add_argument("--no-kid", action="store_true")
    ap.add_argument("--overwrite", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--host-resize", action="store_true",
                    help="PIL's resize on the host; default: the device resize")
    args = ap.parse_args(argv)

    from ieagan_torch.eval.fid import default_extractor, make_custom_kid_stats, make_custom_stats
    from ieagan_torch.train.cli import tool_device

    device = tool_device(args.cpu)
    extractor = default_extractor(device=device)
    print(f"extractor: {extractor.source}", file=sys.stderr)
    common = dict(num=args.num, mode=args.mode, extractor=extractor, overwrite=args.overwrite,
                  resize_on_device=not args.host_resize)
    out = {}
    t0 = time.time()
    out["fid"] = make_custom_stats(args.name, args.real_dir, **common)
    print(f"FID stats -> {out['fid']} ({time.time() - t0:.0f}s)", flush=True)
    if not args.no_kid:
        t0 = time.time()
        out["kid"] = make_custom_kid_stats(args.name, args.real_dir, **common)
        print(f"KID stats -> {out['kid']} ({time.time() - t0:.0f}s)", flush=True)
    return out


if __name__ == "__main__":
    main()
