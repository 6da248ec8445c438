"""MatrixMarket IO so real SuiteSparse matrices (lung2, torso2) can be used
when they lie in a local directory (REPRO_MATRIX_DIR); nothing is
downloaded, and without one `load_named` returns the synthetic analogues.

Port of `repro.sparse.io` (numpy only)."""
from __future__ import annotations

import gzip
import os
from pathlib import Path

import numpy as np

from .csr import CSR, from_coo, tril

__all__ = ["read_matrix_market", "write_matrix_market", "load_named"]


def read_matrix_market(path: str | Path) -> CSR:
    path = Path(path)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt") as f:
        header = f.readline().strip().split()
        assert header[0] == "%%MatrixMarket" and header[1] == "matrix"
        fmt, field, symmetry = header[2], header[3], header[4]
        assert fmt == "coordinate", "only coordinate format supported"
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        nr, nc, nnz = (int(t) for t in line.split())
        data = np.loadtxt(f, max_rows=nnz, ndmin=2)
    rows = data[:, 0].astype(np.int64) - 1
    cols = data[:, 1].astype(np.int64) - 1
    if field == "pattern":
        vals = np.ones(rows.shape[0])
    else:
        vals = data[:, 2].astype(np.float64)
    if symmetry in ("symmetric", "skew-symmetric", "hermitian"):
        off = rows != cols
        sign = -1.0 if symmetry == "skew-symmetric" else 1.0
        rows = np.concatenate([rows, cols[off]])
        cols_new = np.concatenate([cols, data[:, 0].astype(np.int64)[off] - 1])
        vals = np.concatenate([vals, sign * vals[off]])
        cols = cols_new
    return from_coo(rows, cols, vals, (nr, nc))


def write_matrix_market(m: CSR, path: str | Path) -> None:
    path = Path(path)
    rows = np.repeat(np.arange(m.n_rows), m.row_nnz())
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{m.n_rows} {m.n_cols} {m.nnz}\n")
        for r, c, v in zip(rows, m.indices, m.data):
            f.write(f"{r + 1} {c + 1} {v:.17g}\n")


def load_named(name: str) -> CSR:
    """Load a real matrix (lower-triangular part) from REPRO_MATRIX_DIR, or
    fall back to the calibrated synthetic analogue."""
    mdir = os.environ.get("REPRO_MATRIX_DIR")
    if mdir:
        for cand in (Path(mdir) / f"{name}.mtx", Path(mdir) / f"{name}.mtx.gz"):
            if cand.exists():
                full = read_matrix_market(cand)
                L = tril(full, keep_diagonal=True)
                # ensure nonzero diagonal
                d = L.diagonal_fast()
                if np.any(d == 0):
                    raise ValueError(f"{name}: zero diagonal in tril; fixup needed")
                return L
    from . import generators
    if name == "lung2":
        return generators.lung2_like()
    if name == "torso2":
        return generators.torso2_like()
    raise KeyError(name)
