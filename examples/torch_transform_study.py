"""Table I on the PyTorch/CUDA port: the paper's strategies and the
constrained ones beyond it, with the generated code's size, and one
device solve through each transformed system.

    PYTHONPATH=src python examples/torch_transform_study.py               # card
    PYTHONPATH=src python examples/torch_transform_study.py --device cpu  # host

The counterpart of examples/transform_study.py.  The matrices come from
`repro_torch.sparse.io.load_named`: lung2.mtx[.gz] and torso2.mtx[.gz] from
a local REPRO_MATRIX_DIR when it holds them (nothing is downloaded), else
the synthetic analogues; `--scale` below 1.0 takes the analogues at that
scale instead.
"""
import argparse

import numpy as np

from repro_torch.core import (AvgLevelCost, ConstrainedAvgLevelCost,
                              ManualEveryK, NoRewrite, transform)
from repro_torch.solver import TriangularOperator, solve_csr_seq
from repro_torch.sparse import generators
from repro_torch.sparse import io as sio


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="1.0: load_named; below: the analogues at a scale")
    args = ap.parse_args(argv)
    out: dict = {}
    for name in ("lung2", "torso2"):
        L = sio.load_named(name) if args.scale == 1.0 else \
            getattr(generators, f"{name}_like")(scale=args.scale)
        b = np.random.default_rng(0).standard_normal(L.n_rows)
        x_ref = solve_csr_seq(L, b)
        print(f"== {name} (n={L.n_rows}, nnz={L.nnz}) ==")
        for strat in (
                NoRewrite(), AvgLevelCost(), ManualEveryK(10),
                # the paper's §III.A proposed-but-unimplemented constraints
                ConstrainedAvgLevelCost(alpha=8, beta=32, coef_cap=1e6),
                ConstrainedAvgLevelCost(alpha=8, beta=32, coef_cap=1e6,
                                        update_avg=True)):
            ts = transform(L, strat, validate=False)     # with code size
            m = ts.metrics
            r = m.table1_row()
            op = TriangularOperator.from_csr(L, tune=strat, cache=False,
                                             device=args.device)
            err = float(np.abs(op.solve(b, max_refine=0) - x_ref).max() /
                        max(1.0, np.abs(x_ref).max()))
            print(f"  {m.strategy:38s} levels {m.num_levels_before:4d}->"
                  f"{m.num_levels_after:4d} avg x{r['avg_cost_ratio']:6.2f} "
                  f"total {r['total_cost_delta_pct']:+6.1f}% "
                  f"rewr {m.rows_rewritten:6d} maxdist "
                  f"{m.max_rewrite_distance:4d} maxcoef {m.max_abs_coef:.1e} "
                  f"code {r['code_MB']:6.2f} MB  steps "
                  f"{op.schedule.num_steps:4d} err {err:.1e}")
            out[(name, m.strategy)] = {"code_MB": r["code_MB"],
                                       "levels": m.num_levels_after,
                                       "err": err}
    return out


if __name__ == "__main__":
    main()
