"""Sequential reference SpTRSV solvers (numpy) — oracles for everything else.

Copy of `repro.solver.reference` (numpy host half);
tests/test_torch_host_copy.py holds the two equal.
"""
from __future__ import annotations

import numpy as np

from ..sparse.csr import CSR

__all__ = ["solve_csr_seq", "solve_transformed_seq", "solve_dense"]


def solve_csr_seq(L: CSR, b: np.ndarray) -> np.ndarray:
    """Forward substitution, row by row (paper Fig. 1 Algorithm 1)."""
    n = L.n_rows
    x = np.zeros(n, dtype=np.result_type(L.data, b))
    indptr, indices, data = L.indptr, L.indices, L.data
    for i in range(n):
        lo, hi = indptr[i], indptr[i + 1]
        cols = indices[lo:hi]
        vals = data[lo:hi]
        diag = None
        s = 0.0
        for c, v in zip(cols, vals):
            if c == i:
                diag = v
            else:
                s += v * x[c]
        x[i] = (b[i] - s) / diag
    return x


def solve_transformed_seq(ts, b: np.ndarray) -> np.ndarray:
    """Solve via (A', T, d): c = (I+T)^{-1} b; forward substitution over A'.

    Uses the materialized B' when present (c = B'b SpMV), else the T-factor
    preamble (see repro.core.rewrite docstring).
    """
    c = ts.B.matvec(b) if ts.B is not None else ts.preamble(b)
    n = ts.A.n_rows
    x = np.zeros(n, dtype=np.result_type(ts.A.data, b))
    indptr, indices, data = ts.A.indptr, ts.A.indices, ts.A.data
    order = np.argsort(ts.level_of_recomputed, kind="stable")
    for i in order:
        lo, hi = indptr[i], indptr[i + 1]
        s = data[lo:hi] @ x[indices[lo:hi]] if hi > lo else 0.0
        x[i] = (c[i] - s) / ts.diag[i]
    return x


def solve_dense(L: CSR, b: np.ndarray) -> np.ndarray:
    """scipy-based oracle (dense fallback for tiny tests)."""
    import scipy.linalg
    return scipy.linalg.solve_triangular(L.to_dense(), b, lower=True)
