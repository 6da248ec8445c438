"""CSR sparse-matrix container used throughout the framework.

Preprocessing (level sets, graph transformation) runs on numpy int/float
arrays; execution-side structures (ELL level schedules) are staged as torch
tensors by the solver layer.  We deliberately do not depend on scipy for the
core container (scipy is only used as a test oracle).

Copy of `repro.sparse.csr` (numpy host half);
tests/test_torch_host_copy.py holds the two equal.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np

__all__ = ["CSR", "from_coo", "identity", "tril", "triu", "reverse_both",
           "same_pattern"]


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed-sparse-row matrix.

    indptr:  (n_rows + 1,) int64
    indices: (nnz,)        int64, column ids, sorted within a row
    data:    (nnz,)        float64 (or other float dtype)
    shape:   (n_rows, n_cols)
    """

    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray
    shape: tuple[int, int]

    # -- basic properties ---------------------------------------------------
    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def dtype(self):
        return self.data.dtype

    def row(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """(column ids, values) of row i."""
        lo, hi = self.indptr[i], self.indptr[i + 1]
        return self.indices[lo:hi], self.data[lo:hi]

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.indptr)

    # -- ops ----------------------------------------------------------------
    def diagonal(self) -> np.ndarray:
        d = np.zeros(min(self.shape), dtype=self.data.dtype)
        for i in range(min(self.shape)):
            cols, vals = self.row(i)
            hit = np.searchsorted(cols, i)
            if hit < cols.shape[0] and cols[hit] == i:
                d[i] = vals[hit]
        return d

    def diagonal_fast(self) -> np.ndarray:
        """Vectorized diagonal extraction (rows must be column-sorted)."""
        n = min(self.shape)
        rows = np.repeat(np.arange(self.n_rows), self.row_nnz())
        mask = rows == self.indices
        d = np.zeros(n, dtype=self.data.dtype)
        d[rows[mask]] = self.data[mask]
        return d

    def matvec(self, x: np.ndarray, transpose: bool = False) -> np.ndarray:
        """y = A @ x (or A.T @ x) for x of shape (n,) or batched (n, k).

        The transpose path scatters instead of gathers — no materialized
        A.T needed, so iterative-refinement residuals for L^T solves stay
        O(nnz) with zero preprocessing.
        """
        rows = np.repeat(np.arange(self.n_rows), self.row_nnz())
        src, dst, n_out = ((rows, self.indices, self.n_cols) if transpose
                           else (self.indices, rows, self.n_rows))
        gathered = x[src]
        prod = (self.data * gathered if gathered.ndim == 1
                else self.data[:, None] * gathered)
        out = np.zeros((n_out,) + x.shape[1:],
                       dtype=np.result_type(self.data, x))
        np.add.at(out, dst, prod)
        return out

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.data.dtype)
        rows = np.repeat(np.arange(self.n_rows), self.row_nnz())
        out[rows, self.indices] = self.data
        return out

    def transpose_csc_view(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Return (colptr, row_indices, perm) — CSC view of the same matrix.

        perm maps CSC-order positions back into CSR `data` order, so
        data[perm] gives values in CSC order.
        """
        order = np.argsort(self.indices, kind="stable")
        rows = np.repeat(np.arange(self.n_rows), self.row_nnz())
        colptr = np.zeros(self.n_cols + 1, dtype=np.int64)
        counts = np.bincount(self.indices, minlength=self.n_cols)
        colptr[1:] = np.cumsum(counts)
        return colptr, rows[order], order

    def transpose(self) -> "CSR":
        """Materialized A.T as CSR (the CSC view reinterpreted).

        The stable argsort in transpose_csc_view keeps CSR order within a
        column, so the result's rows come out column-sorted without a
        re-sort.
        """
        colptr, rows, perm = self.transpose_csc_view()
        return CSR(indptr=colptr, indices=rows, data=self.data[perm],
                   shape=(self.n_cols, self.n_rows))

    def with_data(self, data: np.ndarray) -> "CSR":
        """Same pattern, new values (shares indptr/indices arrays).

        The primitive under the pattern-frozen refactorization paths:
        `data` must be in this matrix's CSR entry order and is the only
        thing that changes — no re-sort, no structural work.
        """
        data = np.asarray(data)
        if data.shape != self.data.shape:
            raise ValueError(
                f"with_data: expected {self.data.shape[0]} values for the "
                f"frozen pattern, got {data.shape}")
        return CSR(indptr=self.indptr, indices=self.indices, data=data,
                   shape=self.shape)

    def check(self) -> None:
        assert self.indptr.shape == (self.n_rows + 1,)
        assert self.indptr[0] == 0 and self.indptr[-1] == self.nnz
        assert np.all(np.diff(self.indptr) >= 0)
        if self.nnz:
            assert self.indices.min() >= 0 and self.indices.max() < self.n_cols
        # sorted within rows, no duplicates
        for i in range(self.n_rows):
            cols, _ = self.row(i)
            assert np.all(np.diff(cols) > 0), f"row {i} unsorted/dup"

    def __repr__(self) -> str:  # pragma: no cover
        return f"CSR(shape={self.shape}, nnz={self.nnz}, dtype={self.dtype})"


def from_coo(rows: Iterable[int], cols: Iterable[int], vals: Iterable[float],
             shape: tuple[int, int], sum_duplicates: bool = True) -> CSR:
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float64)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    if sum_duplicates and rows.size:
        key_same = (rows[1:] == rows[:-1]) & (cols[1:] == cols[:-1])
        if key_same.any():
            group = np.concatenate([[0], np.cumsum(~key_same)])
            n_groups = group[-1] + 1
            new_vals = np.zeros(n_groups, dtype=vals.dtype)
            np.add.at(new_vals, group, vals)
            first = np.concatenate([[True], ~key_same])
            rows, cols, vals = rows[first], cols[first], new_vals
    indptr = np.zeros(shape[0] + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr)
    return CSR(indptr=indptr, indices=cols, data=vals, shape=shape)


def identity(n: int, dtype=np.float64) -> CSR:
    return CSR(indptr=np.arange(n + 1, dtype=np.int64),
               indices=np.arange(n, dtype=np.int64),
               data=np.ones(n, dtype=dtype), shape=(n, n))


def tril(m: CSR, keep_diagonal: bool = True) -> CSR:
    """Lower-triangular part of `m` (optionally including the diagonal)."""
    rows = np.repeat(np.arange(m.n_rows), m.row_nnz())
    keep = m.indices < rows + (1 if keep_diagonal else 0)
    return from_coo(rows[keep], m.indices[keep], m.data[keep], m.shape,
                    sum_duplicates=False)


def triu(m: CSR, keep_diagonal: bool = True) -> CSR:
    """Upper-triangular part of `m` (optionally including the diagonal)."""
    rows = np.repeat(np.arange(m.n_rows), m.row_nnz())
    keep = m.indices > rows - (1 if keep_diagonal else 0)
    return from_coo(rows[keep], m.indices[keep], m.data[keep], m.shape,
                    sum_duplicates=False)


def same_pattern(a: CSR, b: CSR) -> bool:
    """True when `a` and `b` have identical sparsity patterns.

    Identical means the same shape and bitwise-equal indptr/indices — the
    exact precondition of every value-only fast path (`update_values`,
    `factorize.refactor`): equal patterns guarantee entry k of one matrix
    addresses the same (row, col) as entry k of the other.
    """
    return (a.shape == b.shape
            and a.indptr.shape == b.indptr.shape
            and a.indices.shape == b.indices.shape
            and np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices))


def reverse_both(m: CSR) -> CSR:
    """P @ m @ P for the reversal permutation P (i -> n-1-i on both axes).

    Reversing both axes turns an upper-triangular matrix into a
    lower-triangular one with the same dependency DAG (edges reversed in
    row order) — the bridge that lets upper/transpose solves reuse the
    lower-triangular schedule compiler: solve(U, b) == reverse(
    solve(reverse_both(U), reverse(b))).
    """
    rows = np.repeat(np.arange(m.n_rows), m.row_nnz())
    return from_coo(m.n_rows - 1 - rows, m.n_cols - 1 - m.indices, m.data,
                    m.shape, sum_duplicates=False)
