"""Time stepping with pattern-frozen refactorization on the PyTorch/CUDA
port: the scenario `update_values` and `refactor` exist for.

    PYTHONPATH=src python examples/torch_timestepping.py               # card
    PYTHONPATH=src python examples/torch_timestepping.py --device cpu  # host

The counterpart of examples/timestepping.py.  An implicit stepper solves
(I + dt K_k) x_{k+1} = x_k, whose values change every step while the
sparsity pattern never does.  Level analysis, transformation, tuning,
schedule compilation and, on a card, the packing of the SpTRSV kernel's
tiles are paid once; each step re-binds the values:

    op = TriangularOperator.from_csr(L_0, tune="auto")   # once
    for k in steps:
        op.update_values(L_k)   # transform replay, value repack, and on a
        x = op.solve(b)         # card a device refresh of the packed tiles

`Preconditioner.refactor(A_k)` does the same one level up: only the
numeric IC(0) sweeps run again, and both triangular halves are re-bound.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import faults
from repro_torch.core.resilience import PatternMismatchError
from repro_torch.iterative import cg
from repro_torch.precond import Preconditioner
from repro_torch.solver import TriangularOperator
from repro_torch.sparse import generators


def step_lower(L, k: int):
    """Step k's lower factor: same pattern, perturbed values."""
    rng = np.random.default_rng(100 + k)
    rows = np.repeat(np.arange(L.n_rows), L.row_nnz())
    d = L.indices == rows
    data = L.data * (1.0 + 0.2 * rng.standard_normal(L.nnz))
    data[d] = L.data[d] * (1.2 + 0.1 * k)
    return L.with_data(data)


def step_spd(A, k: int):
    """Step k's SPD system: symmetric value perturbation, heavier diagonal
    (a shifted/damped implicit step), identical pattern."""
    rows = np.repeat(np.arange(A.n_rows), A.row_nnz())
    pair = np.minimum(rows, A.indices) * A.n_cols + \
        np.maximum(rows, A.indices)
    data = A.data * (1.0 + 0.05 * np.sin(pair * 12.9898 + k))
    data[rows == A.indices] = A.data[rows == A.indices] * (2.0 + 0.1 * k)
    return A.with_data(data)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--n", type=int, default=1500,
                    help="rows of the random lower factor")
    ap.add_argument("--grid", type=int, default=28,
                    help="poisson2d_spd grid side of the PCG stepper")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    out: dict = {"residuals": [], "pcg_iters": []}

    # -- triangular operator: update_values per step ------------------------
    L = generators.random_lower(args.n, avg_offdiag=3.0, seed=0, max_back=40)
    b = np.random.default_rng(0).standard_normal(L.n_rows)
    t0 = time.perf_counter()
    op = TriangularOperator.from_csr(L, tune="auto", device=dev)
    op.solve(b)
    print(f"build+tune once: {(time.perf_counter() - t0) * 1e3:7.1f}ms  "
          f"pick={op.strategy}  device={op.device}")
    for k in range(4):
        L_k = step_lower(L, k)
        t0 = time.perf_counter()
        op.update_values(L_k)                # pattern frozen, values rebound
        x = op.solve(b)
        step_ms = (time.perf_counter() - t0) * 1e3
        r = float(np.abs(L_k.matvec(x) - b).max())
        out["residuals"].append(r)
        print(f"step {k}: update+solve {step_ms:7.2f}ms  residual={r:.2e}  "
              f"(update #{op.stats.value_updates}, "
              f"{op.stats.last_update_ms:.2f}ms)")
    assert op.stats.value_updates == 4

    # -- preconditioner: refactor per step ----------------------------------
    A = generators.poisson2d_spd(args.grid, args.grid)
    rhs = torch.as_tensor(np.random.default_rng(1).standard_normal(A.n_rows),
                          device=dev)
    t0 = time.perf_counter()
    P = Preconditioner.ic0(A, tune="auto", device=dev)
    print(f"\nic0 factor+tune once: {(time.perf_counter() - t0) * 1e3:7.1f}ms"
          f"  pick={P.strategy}")
    for k in range(3):
        A_k = step_spd(A, k)
        t0 = time.perf_counter()
        P.refactor(A_k)                      # numeric sweeps only
        res = cg(A_k, rhs, preconditioner=P, tol=1e-6, device=dev)
        step_ms = (time.perf_counter() - t0) * 1e3
        out["pcg_iters"].append(int(res.iterations))
        print(f"step {k}: refactor+pcg {step_ms:7.1f}ms  "
              f"iters={int(res.iterations):3d} "
              f"resid={float(res.final_residual()):.2e}")
        assert bool(res.converged), k
    assert P.forward.stats.value_updates == 3

    # a drifted pattern is rejected, never silently absorbed
    try:
        op.update_values(faults.pattern_drift(L))
        out["drift_rejected"] = False
    except PatternMismatchError as e:
        out["drift_rejected"] = True
        print(f"\ndrifted pattern rejected: {e}")
    return out


if __name__ == "__main__":
    main()
