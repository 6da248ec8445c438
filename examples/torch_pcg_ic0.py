"""IC(0)-preconditioned CG on the PyTorch/CUDA port, in float64.

    PYTHONPATH=src python examples/torch_pcg_ic0.py               # card
    PYTHONPATH=src python examples/torch_pcg_ic0.py --device cpu  # host

The counterpart of examples/pcg_ic0.py: the outer CG iterations run in
float64 torch on the device, and both halves of M^-1 = (L L^T)^-1 run the
SpTRSV kernel on a card (the forward sweep L and the backward sweep L^T
through transpose=True), each with its own tuned transformation.  No
precision switch is needed: torch's float64 is a dtype, not a mode.
"""
import argparse

import numpy as np
import torch

from repro_torch.iterative import cg
from repro_torch.precond import Preconditioner
from repro_torch.sparse import generators


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--grid", type=int, default=24,
                    help="poisson2d_spd grid side (n = grid^2)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    A = generators.poisson2d_spd(args.grid, args.grid)
    n = A.n_rows
    rng = np.random.default_rng(0)
    x_true = rng.standard_normal(n)
    b = torch.as_tensor(A.matvec(x_true), dtype=torch.float64, device=dev)

    base = cg(A, b, tol=1e-8, device=dev)
    print(f"{'unpreconditioned':>16s}  cg_iters={int(base.iterations):3d} "
          f"resid={float(base.final_residual()):.2e}")
    out = {"base_iters": int(base.iterations)}
    for tune in ("no_rewriting", "avgLevelCost", "auto"):
        P = Preconditioner.ic0(A, tune=tune, device=dev)
        res = cg(A, b, preconditioner=P, tol=1e-8, device=dev)
        err = float((res.x.cpu() - torch.as_tensor(x_true)).abs().max())
        label = P.strategy if tune == "auto" else tune
        print(f"{tune:>16s}  cg_iters={int(res.iterations):3d} "
              f"resid={float(res.final_residual()):.2e} err={err:.2e} "
              f"sched_steps={P.forward.schedule.num_steps:3d} pick={label}")
        assert bool(res.converged), tune
        assert int(res.iterations) < int(base.iterations), \
            f"{tune}: preconditioning must cut iterations"
        out[tune] = {"iters": int(res.iterations), "err": err}

    # batched right-hand sides stream the same schedules once per step
    B = torch.as_tensor(rng.standard_normal((n, 8)), device=dev)
    P = Preconditioner.ic0(A, tune="auto", device=dev)
    resb = cg(A, B, preconditioner=P, tol=1e-8, device=dev)
    print(f"{'batched k=8':>16s}  cg_iters={resb.iterations.cpu().numpy()} "
          f"all_converged={bool(resb.converged.all())}")
    out["batched_converged"] = bool(resb.converged.all())
    return out


if __name__ == "__main__":
    main()
