"""Quickstart on the PyTorch/CUDA port: auto-tune, compile and solve a
sparse triangular system on the card.

    PYTHONPATH=src python examples/torch_quickstart.py               # card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # host

The counterpart of examples/quickstart.py.  On a card the solves run the
SpTRSV kernel (K1 for one column, K2 for several); with `--device cpu`
they run its plain PyTorch version.
"""
import argparse

import numpy as np
import torch

from repro_torch.kernels import sptrsv_level as K
from repro_torch.solver import TriangularOperator, solve_csr_seq, sptrsv
from repro_torch.sparse import build_levels, generators


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--scale", type=float, default=0.1,
                    help="lung2_like scale (1.0: n=109,460)")
    args = ap.parse_args(argv)
    dev = args.device
    K.LAUNCHES.reset()

    # 1. a matrix with thin levels (long dependency chains)
    L = generators.lung2_like(scale=args.scale)
    levels = build_levels(L)
    print(f"matrix: n={L.n_rows} nnz={L.nnz} levels={levels.num_levels}")

    # 2. one entry point: the portfolio auto-tuner picks the transformation
    #    strategy, compiles the schedule, stages it on the device and
    #    caches the artifact by the matrix fingerprint
    op = TriangularOperator.from_csr(L, tune="auto", chunk=128, max_deps=8,
                                     device=dev)
    print(f"\ntuner pick: {op.strategy} ({op.schedule.num_steps} steps, "
          f"engine={op.engine}, device={op.device}, "
          f"cache={op.stats.cache_source})")
    print("\nranked strategy report:")
    print(op.report.table() if op.report is not None else "(cached)")

    # 3. one right-hand side, float64 accuracy by iterative refinement
    b = np.random.default_rng(0).standard_normal(L.n_rows)
    x = op.solve(b)
    x_ref = solve_csr_seq(L, b)
    err = float(np.abs(x - x_ref).max())
    print(f"\nsingle RHS: max err {err:.2e} (residual "
          f"{op.stats.last_residual:.2e}, {op.stats.refine_rounds} "
          f"refinement rounds)")

    # 4. batched (n, 8): one schedule streamed for all eight columns
    B = np.random.default_rng(1).standard_normal((L.n_rows, 8))
    X = op.solve(B)
    err_b = max(float(np.abs(X[:, j] - solve_csr_seq(L, B[:, j])).max())
                for j in range(B.shape[1]))
    print(f"batched (n, 8): max err {err_b:.2e}")

    # 5. L then L^T: the transpose operator solves the reversed-transposed
    #    lower system through the same compiler, engines and cache
    op_t = TriangularOperator.from_csr(L, tune="auto", chunk=128,
                                       max_deps=8, transpose=True,
                                       device=dev)
    z = op_t.solve(op.solve(b))
    z_ref = np.linalg.solve(L.to_dense().T, x_ref)
    err_t = float(np.abs(z - z_ref).max())
    print(f"\nL then L^T round-trip: max err {err_t:.2e}")

    # 6. differentiable solves: the backward pass of sptrsv is the
    #    transposed sweep, on the same device
    bt = torch.as_tensor(b, dtype=torch.float32, device=op.device)
    bt.requires_grad_(True)
    sptrsv(L, bt, tune="no_rewriting", chunk=128, max_deps=8,
           device=dev).sum() \
        .backward()
    g_ref = np.linalg.solve(L.to_dense().T, np.ones(L.n_rows))  # L^-T 1
    err_g = float(np.abs(bt.grad.double().cpu().numpy() - g_ref).max() /
                  max(1.0, np.abs(g_ref).max()))
    print(f"torch.autograd through sptrsv: max err {err_g:.2e} "
          f"(relative to max|g|)")
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    print(f"\nkernel launches: {launches or '(plain version on the CPU)'}")
    print(f"per-solve stats: {op.stats.to_dict()}")
    return {"err": err, "err_batched": err_b, "err_transpose": err_t,
            "err_grad": err_g, "strategy": op.strategy,
            "launches": launches}


if __name__ == "__main__":
    main()
