"""Fit the tuner's cost constants on this machine from the per-step profile.

    python -m repro_torch.obs.calibrate [--device cpu|cuda] [--scale S]
                                        [--matrices NAME ...]

Builds `TriangularOperator.from_csr(M, tune="no_rewriting")` for each
generator NAME (default lung2_like and torso2_like) at scale S on the
device, profiles each with `profile_operator` (the plain engine step by
step on the CPU, K1's stamps on the card), merges the profiles and fits
`CostModel.calibrate` from zero rates.  Prints the constants, the device
and each profile's totals as one JSON object.

`repro_torch.core.portfolio`'s CPU constants come from `--device cpu
--scale 0.25 --matrices lung2_like`: the plain engine's step pads every
width group, so a schedule's steps all have the same columns, and two
schedules give two distinct points for three constants (a fit that
`calibrate`'s clamping leaves wrong); one schedule's mean step is the
CPU's step cost.  The card's come from `chip_smoke.py`, which calls
`calibrate_on` at scale 1.0 on both matrices, whose packed steps vary.
"""
from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch

__all__ = ["calibrate_on", "PROFILED"]

PROFILED = ("lung2_like", "torso2_like")


def calibrate_on(device=None, scale: float = 1.0, reps: int = 3,
                 warmup: int = 1, matrices=PROFILED) -> tuple:
    """(calibrated CostModel, {name: (operator, ScheduleProfile)}) for the
    no_rewriting sweeps of `matrices` at `scale` on `device`."""
    from ..core.portfolio import CostModel
    from ..solver.operator import TriangularOperator
    from ..sparse import generators
    from .profile import merge_profiles, profile_operator
    out = {}
    for name in matrices:
        L = getattr(generators, name)(scale)
        op = TriangularOperator.from_csr(L, tune="no_rewriting",
                                         device=device, cache=False)
        out[name] = (op, profile_operator(op, reps=reps, warmup=warmup))
    zero = CostModel(step_overhead_us=0.0, us_per_padded_flop=0.0,
                     us_per_byte=0.0)
    model = zero.calibrate(merge_profiles(p for _, p in out.values()))
    return model, out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: cuda, as every entry point)")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--matrices", nargs="+", default=list(PROFILED))
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    model, profiles = calibrate_on(args.device, args.scale, reps=args.reps,
                                   matrices=args.matrices)
    dev = next(iter(profiles.values()))[0].device
    print(json.dumps({
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "torch_threads": torch.get_num_threads(), "scale": args.scale,
        "cost_model": dataclasses.asdict(model),
        "profiles": {name: {"engine": p.engine, "steps": p.num_steps,
                            "total_ms": p.total_ms(),
                            "median_step_us": float(np.median(p.step_ms))
                            * 1e3, "launch_us": p.launch_us}
                     for name, (_, p) in profiles.items()},
        "seconds": time.perf_counter() - t0}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
