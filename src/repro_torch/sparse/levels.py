"""Level-set construction for lower-triangular sparse matrices.

The dependency DAG of L has an edge j -> i for every strict-lower nonzero
L[i, j].  level(i) = 1 + max(level(j) for j in deps(i)), level = 0 for rows
with no strict-lower nonzeros.  This is the classic level-set / wavefront
method [Anderson & Saad 1989; Saltz 1990] the paper builds on.

Implementation: vectorized topological sweep.  Because L is lower triangular,
row order is already a topological order, so a single forward pass computes
exact levels in O(nnz) with numpy, without Kahn queues.

Copy of `repro.sparse.levels` (numpy host half);
tests/test_torch_host_copy.py holds the two equal.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .csr import CSR

__all__ = ["LevelSets", "build_levels", "level_costs", "row_costs"]


@dataclasses.dataclass(frozen=True)
class LevelSets:
    """Partition of rows into dependency levels.

    level_of:    (n,) int64, level id per row
    order:       (n,) int64, rows sorted by (level, row id)
    level_ptr:   (num_levels + 1,) int64 offsets into `order`
    """

    level_of: np.ndarray
    order: np.ndarray
    level_ptr: np.ndarray

    @property
    def num_levels(self) -> int:
        return int(self.level_ptr.shape[0] - 1)

    def rows_in_level(self, lvl: int) -> np.ndarray:
        return self.order[self.level_ptr[lvl]:self.level_ptr[lvl + 1]]

    def level_sizes(self) -> np.ndarray:
        return np.diff(self.level_ptr)


def build_levels(L: CSR) -> LevelSets:
    """Compute level sets of lower-triangular CSR matrix L.

    Pure-python loop over rows would be O(n) python overhead; instead we do a
    blocked forward sweep: process rows in order, but vectorize the
    max-over-deps with np.maximum.reduceat per row block.  For full
    vectorization we exploit that dependencies always point backwards.
    """
    n = L.n_rows
    indptr, indices = L.indptr, L.indices
    # strict-lower mask per entry
    rows = np.repeat(np.arange(n), np.diff(indptr))
    strict = indices < rows
    # level[i] = 1 + max(level[j] for j strict deps); level[j] values are
    # produced during the same sweep, so a fully vectorized one-shot pass is
    # impossible in general.  Instead sweep in "waves": repeatedly assign
    # levels to rows whose deps are all assigned.  Number of waves = DAG
    # depth, each wave vectorized -> O(depth * nnz) worst case.
    sl_counts = np.zeros(n, dtype=np.int64)
    np.add.at(sl_counts, rows[strict], 1)
    level = _wave_sweep(n, rows, indices, strict, sl_counts)
    order = np.lexsort((np.arange(n), level))
    num_levels = int(level.max()) + 1 if n else 0
    counts = np.bincount(level, minlength=num_levels)
    level_ptr = np.zeros(num_levels + 1, dtype=np.int64)
    level_ptr[1:] = np.cumsum(counts)
    return LevelSets(level_of=level, order=order, level_ptr=level_ptr)


def _wave_sweep(n: int, rows: np.ndarray, cols: np.ndarray, strict: np.ndarray,
                sl_counts: np.ndarray) -> np.ndarray:
    """Kahn-style wavefront levelization, vectorized per wave."""
    level = np.full(n, -1, dtype=np.int64)
    remaining = sl_counts.copy()
    # adjacency in CSC-ish form: for each column j, the dependent rows i
    srows, scols = rows[strict], cols[strict]
    order = np.argsort(scols, kind="stable")
    srows_by_col = srows[order]
    colptr = np.zeros(n + 1, dtype=np.int64)
    colptr[1:] = np.cumsum(np.bincount(scols, minlength=n))

    frontier = np.flatnonzero(remaining == 0)
    level[frontier] = 0
    cur = 0
    while frontier.size:
        # all rows depending on the frontier get their counters decremented
        lo, hi = colptr[frontier], colptr[frontier + 1]
        if lo.size == 0:
            break
        # gather dependents
        seg_lens = hi - lo
        total = int(seg_lens.sum())
        if total == 0:
            break
        idx = np.repeat(lo, seg_lens) + _segment_arange(seg_lens)
        dependents = srows_by_col[idx]
        np.subtract.at(remaining, dependents, 1)
        ready = np.unique(dependents[remaining[dependents] == 0])
        cur += 1
        level[ready] = cur
        frontier = ready
    assert (level >= 0).all(), "cycle detected — matrix not lower-triangular?"
    return level


def _segment_arange(seg_lens: np.ndarray) -> np.ndarray:
    """[0..l0-1, 0..l1-1, ...] for segment lengths seg_lens (vectorized)."""
    total = int(seg_lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    ends = np.cumsum(seg_lens)
    starts = ends - seg_lens
    r = np.arange(total, dtype=np.int64)
    return r - np.repeat(starts, seg_lens)


# -- cost model (paper §III) -------------------------------------------------

def row_costs(L: CSR) -> np.ndarray:
    """cost(row) = 2*nnz(row) - 1 (nnz includes the diagonal)."""
    return 2 * L.row_nnz() - 1


def level_costs(L: CSR, levels: LevelSets) -> np.ndarray:
    """cost(level) = sum of row costs = 2*sum(nnz) - n_rows_in_level."""
    rc = row_costs(L)
    out = np.zeros(levels.num_levels, dtype=np.int64)
    np.add.at(out, levels.level_of, rc)
    return out
