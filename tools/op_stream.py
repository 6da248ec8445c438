#!/usr/bin/env python3
"""The dot-op stream of one train step of the port over meta tensors, and
the difference between two such streams (two torch versions, say).

    PYTHONPATH=src python -m tools.op_stream --out ops.json \
        [--arch internlm2-1.8b] [--batch 4] [--seq 1024]
    python -m tools.op_stream --diff a.json b.json

The first form counts one unplaced train step of the arch's full config
(`repro_torch.launch.dryrun.count_train_step`, the count `chip_smoke.py`
phase 15 holds the card's step to) with remat on and with remat off,
and writes the torch version, each run's totals and its dot ops (name,
operand shapes, FLOPs, and whether it ran inside autograd's backward,
as a checkpoint's recompute does) to the JSON file.  The second groups
each file's dots by (name, shapes, in backward) and prints the totals and
every group whose count differs, with its FLOPs in each file.  Imports
torch and the port only.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys


def record(arch: str, batch: int, seq: int) -> dict:
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import count_train_step
    torch.set_num_threads(1)
    cfg = get_config(arch)
    out = {"torch": torch.__version__, "arch": arch, "batch": batch,
           "seq": seq, "n_layers": cfg.n_layers,
           "remat_group": cfg.remat_group}
    for name, remat in (("remat", True), ("no_remat", False)):
        res = count_train_step(dataclasses.replace(cfg, remat=remat),
                               batch, seq, record_dots=True)
        out[name] = {"flops": res["flops"], "dots": res["dots"]}
    return out


def _groups(dots) -> collections.Counter:
    return collections.Counter(
        (name, json.dumps(shapes), bool(bwd)) for name, shapes, _, bwd in dots)


def _flops_of(dots) -> dict:
    return {(name, json.dumps(shapes), bool(bwd)): f
            for name, shapes, f, bwd in dots}


def diff(a: dict, b: dict) -> list[str]:
    lines = [f"A: torch {a['torch']}, B: torch {b['torch']}; {a['arch']}, "
             f"batch {a['batch']}, seq {a['seq']}, {a['n_layers']} layers, "
             f"remat groups of {a['remat_group']}"]
    for run in ("remat", "no_remat"):
        da, db = a[run]["dots"], b[run]["dots"]
        ga, gb = _groups(da), _groups(db)
        fl = {**_flops_of(da), **_flops_of(db)}
        lines.append(f"{run}: FLOPs A {a[run]['flops']:.6e}, "
                     f"B {b[run]['flops']:.6e}; dots A {len(da)}, "
                     f"B {len(db)}")
        for key in sorted(set(ga) | set(gb), key=lambda k: -fl[k]):
            if ga[key] != gb[key]:
                name, shapes, bwd = key
                lines.append(
                    f"  {name} {shapes} {'backward' if bwd else 'forward'}:"
                    f" A {ga[key]}, B {gb[key]} ({fl[key]:.4e} FLOPs each;"
                    f" B - A = {(gb[key] - ga[key]) * fl[key]:.4e})")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--diff", nargs=2, metavar=("A", "B"))
    args = ap.parse_args(argv)
    if args.diff:
        a, b = (json.loads(open(p).read()) for p in args.diff)
        print("\n".join(diff(a, b)))
        return 0
    if not args.out:
        ap.error("--out or --diff is required")
    res = record(args.arch, args.batch, args.seq)
    with open(args.out, "w") as f:
        json.dump(res, f)
    print(f"torch {res['torch']}: remat {res['remat']['flops']:.6e} FLOPs "
          f"({len(res['remat']['dots'])} dots), no remat "
          f"{res['no_remat']['flops']:.6e} ({len(res['no_remat']['dots'])})"
          f"; wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
