"""Synthetic lower-triangular matrix generators.

The container has no network access, so the SuiteSparse matrices used by the
paper (lung2, torso2) are replaced by *structural analogues* calibrated to the
statistics reported in the paper (see DESIGN.md §5).  All generators return
CSR lower-triangular matrices with unit-scale, diagonally-dominant values so
triangular solves are numerically well-behaved in tests.

Level structure is controlled exactly: a generator takes a rows-per-level
profile and an in-degree distribution, then wires each row's dependencies to
rows in *previous* levels (at controlled level distances), guaranteeing the
level-set builder recovers the intended profile.

Copy of `repro.sparse.generators` (numpy host half);
tests/test_torch_host_copy.py holds the two equal.
"""
from __future__ import annotations

import numpy as np

from .csr import CSR, from_coo

__all__ = [
    "chain", "random_lower", "banded", "poisson2d_ic0",
    "from_level_profile", "lung2_like", "torso2_like", "with_values",
    "poisson2d_spd", "poisson3d_spd", "random_spd", "spd_from_lower",
]


def _values_for(rows: np.ndarray, cols: np.ndarray, n: int,
                rng: np.random.Generator) -> np.ndarray:
    """Diagonally dominant values: |diag| > sum |off-diag| per row."""
    vals = rng.uniform(-1.0, 1.0, size=rows.shape[0])
    diag_mask = rows == cols
    # set diagonal to (sum of |offdiag| in the row) + U(1, 2)
    abssum = np.zeros(n)
    np.add.at(abssum, rows[~diag_mask], np.abs(vals[~diag_mask]))
    vals[diag_mask] = (abssum[rows[diag_mask]] + rng.uniform(1.0, 2.0, diag_mask.sum()))
    return vals


def chain(n: int, seed: int = 0) -> CSR:
    """Pure dependency chain: row i depends on row i-1.  Worst case: n levels."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([np.arange(n), np.arange(1, n)])
    cols = np.concatenate([np.arange(n), np.arange(n - 1)])
    vals = _values_for(rows, cols, n, rng)
    return from_coo(rows, cols, vals, (n, n), sum_duplicates=False)


def banded(n: int, bandwidth: int, seed: int = 0) -> CSR:
    """Dense band of width `bandwidth` below the diagonal."""
    rng = np.random.default_rng(seed)
    r, c = [], []
    for b in range(bandwidth + 1):
        r.append(np.arange(b, n))
        c.append(np.arange(0, n - b))
    rows, cols = np.concatenate(r), np.concatenate(c)
    vals = _values_for(rows, cols, n, rng)
    return from_coo(rows, cols, vals, (n, n))


def random_lower(n: int, avg_offdiag: float = 3.0, seed: int = 0,
                 max_back: int | None = None) -> CSR:
    """Random lower-triangular matrix with ~avg_offdiag strict-lower nnz/row.

    max_back limits how far back dependencies reach (bandwidth-ish bound).
    """
    rng = np.random.default_rng(seed)
    counts = rng.poisson(avg_offdiag, size=n)
    counts = np.minimum(counts, np.arange(n))  # row i has at most i deps
    if max_back is not None:
        counts = np.minimum(counts, max_back)
    total = int(counts.sum())
    rows = np.repeat(np.arange(n), counts)
    lo = rows - (max_back if max_back is not None else rows)
    lo = np.maximum(lo, 0)
    u = rng.random(total)
    cols = (lo + u * (rows - lo)).astype(np.int64)
    cols = np.minimum(cols, rows - 1)
    # diagonal
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.arange(n)])
    vals = np.ones(rows.shape[0])
    m = from_coo(rows, cols, vals, (n, n), sum_duplicates=True)
    # re-randomize values after dedup
    r2 = np.repeat(np.arange(n), m.row_nnz())
    data = _values_for(r2, m.indices, n, rng)
    return CSR(indptr=m.indptr, indices=m.indices, data=data, shape=m.shape)


def poisson2d_ic0(nx: int, ny: int, seed: int = 0) -> CSR:
    """Lower-triangular part of the 5-point Laplacian on an nx*ny grid.

    Structure matches the IC(0) factor sparsity used in preconditioned CG —
    the paper's motivating application class.
    """
    rng = np.random.default_rng(seed)
    n = nx * ny
    idx = np.arange(n)
    ix, iy = idx % nx, idx // nx
    rows, cols = [idx], [idx]
    west = idx[ix > 0]
    rows.append(west); cols.append(west - 1)
    south = idx[iy > 0]
    rows.append(south); cols.append(south - nx)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    vals = _values_for(rows, cols, n, rng)
    return from_coo(rows, cols, vals, (n, n))


def from_level_profile(level_sizes: np.ndarray,
                       indegree_sampler,
                       distance_sampler,
                       seed: int = 0,
                       locality: float | None = None) -> CSR:
    """Build a lower-triangular matrix with an exact rows-per-level profile.

    level_sizes:      rows per level, level_sizes[0] >= 1 (roots).
    indegree_sampler: f(rng, level_id, n_rows) -> int array of strict-lower
                      in-degrees for that level's rows (>=1 for level>0).
    distance_sampler: f(rng, level_id, k) -> int array (k,) of level distances
                      (>=1) for dependency targets; one dep per row is forced
                      to distance 1 so the row's level is exact.
    locality:         if set (e.g. 0.02), rows carry a spatial coordinate
                      u = rank/level_size and dependencies target rows with
                      similar u in earlier levels (sigma = locality).  This is
                      the mesh-locality of FEM discretizations (torso2): deep
                      substitution chains then share ancestors, so the
                      rearrangement step of the rewriting engine dedupes them
                      instead of exploding the in-degree.
    """
    rng = np.random.default_rng(seed)
    level_sizes = np.asarray(level_sizes, dtype=np.int64)
    assert level_sizes[0] >= 1
    num_levels = level_sizes.shape[0]
    n = int(level_sizes.sum())
    # row ids per level (contiguous, ascending with level => lower triangular)
    starts = np.concatenate([[0], np.cumsum(level_sizes)])
    rows_list, cols_list = [], []

    def _pick(tgt_lvl: np.ndarray, u: np.ndarray) -> np.ndarray:
        """Choose one row id inside each target level, locality-aware."""
        lo, hi = starts[tgt_lvl], starts[tgt_lvl + 1]
        if locality is None:
            return lo + (rng.random(tgt_lvl.shape[0]) * (hi - lo)).astype(np.int64)
        uu = np.clip(u + rng.normal(0.0, locality, size=u.shape[0]), 0.0, 1.0 - 1e-9)
        return lo + (uu * (hi - lo)).astype(np.int64)

    for lvl in range(1, num_levels):
        m = int(level_sizes[lvl])
        rids = np.arange(starts[lvl], starts[lvl + 1])
        upos = (np.arange(m) + 0.5) / m
        indeg = np.asarray(indegree_sampler(rng, lvl, m), dtype=np.int64)
        indeg = np.maximum(indeg, 1)
        # dep #1: distance 1 (pins the level)
        dep1 = _pick(np.full(m, lvl - 1, dtype=np.int64), upos)
        rows_list.append(rids); cols_list.append(dep1)
        # extra deps: sampled level distances
        extra = indeg - 1
        tot = int(extra.sum())
        if tot:
            rr = np.repeat(rids, extra)
            uu = np.repeat(upos, extra)
            dist = np.asarray(distance_sampler(rng, lvl, tot), dtype=np.int64)
            dist = np.clip(dist, 1, lvl)
            cc = _pick(lvl - dist, uu)
            rows_list.append(rr); cols_list.append(cc)
    rows = np.concatenate(rows_list) if rows_list else np.zeros(0, np.int64)
    cols = np.concatenate(cols_list) if cols_list else np.zeros(0, np.int64)
    # diagonal
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.arange(n)])
    vals = np.ones(rows.shape[0])
    m = from_coo(rows, cols, vals, (n, n), sum_duplicates=True)
    r2 = np.repeat(np.arange(n), m.row_nnz())
    data = _values_for(r2, m.indices, n, rng)
    return CSR(indptr=m.indptr, indices=m.indices, data=data, shape=m.shape)


def lung2_like(scale: float = 1.0, seed: int = 7) -> CSR:
    """Structural analogue of SuiteSparse lung2's lower-triangular part.

    Calibration targets (paper Table I + text): n = 109,460; nnz(L) ~ 273,647;
    479 levels; 453 levels (94%) with exactly 2 rows; total level cost 437,834
    (cost = 2*nnz - n); avg level cost ~ 914.

    Structure: 26 fat levels carrying ~108.5k rows, interleaved with 6 runs of
    2-row thin chain levels (453 total).  Thin rows have in-degree 1; fat rows
    in-degree ~1.5 (to hit the nnz budget).
    """
    # 479 levels: fat levels at positions spread out; thin runs between.
    n_target = int(round(109_460 * scale))
    thin_levels = 453
    fat_levels = 26
    thin_rows = 2 * thin_levels
    fat_rows_total = n_target - thin_rows
    fat_sizes = _spread(fat_rows_total, fat_levels)
    # interleave: fat0 [thin run] fat1 [thin run] ... runs roughly equal
    runs = _spread(thin_levels, fat_levels - 1)  # thin run between fats
    sizes = []
    kinds = []
    for i in range(fat_levels):
        sizes.append(fat_sizes[i]); kinds.append("fat")
        if i < fat_levels - 1:
            sizes.extend([2] * runs[i]); kinds.extend(["thin"] * runs[i])
    level_sizes = np.asarray(sizes, dtype=np.int64)
    assert level_sizes.sum() == n_target and level_sizes.shape[0] == 479

    kinds = np.asarray(kinds)

    def indeg(rng, lvl, m):
        if kinds[lvl] == "thin":
            return np.ones(m, dtype=np.int64)
        # fat rows: mostly 1 dep, some 2 — tune to hit nnz ~ 273,647
        return 1 + (rng.random(m) < 0.50).astype(np.int64)

    def dist(rng, lvl, k):
        # deps point to nearby levels (spatial locality of lung2 discretization)
        return 1 + rng.geometric(0.8, size=k) - 1 + 1  # mostly 1-2

    return from_level_profile(level_sizes, indeg, dist, seed=seed)


def torso2_like(scale: float = 1.0, seed: int = 11) -> CSR:
    """Structural analogue of SuiteSparse torso2's lower-triangular part.

    Calibration targets: n = 115,967; nnz(L) ~ 575,726; 513 levels; a smooth
    triangular rows-per-level profile (no long 2-row chains); total level cost
    ~1,035,484; avg level cost ~2014.6.
    """
    n_target = int(round(115_967 * scale))
    num_levels = 513
    # triangular rows-per-level profile (paper: "torso2 has a triangular shape
    # in terms of number of rows in a level" and "many rows in a level, the
    # variation is much less across levels"): linear taper from ~2x mean to
    # ~1/4 mean — thin levels are *moderately* thin, no 2-row chains.
    x = np.arange(num_levels, dtype=np.float64)
    prof = 2.0 - 1.75 * x / (num_levels - 1)
    sizes = np.maximum(1, np.round(prof / prof.sum() * n_target)).astype(np.int64)
    # fix rounding to hit n exactly
    diff = n_target - int(sizes.sum())
    sizes[np.argmax(sizes)] += diff
    assert sizes.sum() == n_target

    def indeg(rng, lvl, m):
        # ~5 nnz/row in L => ~4 strict-lower deps, varying
        return 1 + rng.poisson(3.2, size=m)

    def dist(rng, lvl, k):
        return 1 + rng.geometric(0.45, size=k) - 1 + 1  # spread over few levels

    # mesh locality: FEM neighbours share ancestors (see from_level_profile)
    return from_level_profile(sizes, indeg, dist, seed=seed, locality=0.003)


# -- SPD generators (factorization inputs for repro.precond) ------------------
#
# The triangular generators above produce *factors*; the preconditioning
# subsystem needs full SPD (or general square) *systems* to factor.  These
# return symmetric positive-definite CSR matrices directly, so examples and
# tests no longer have to assemble A = L @ L.T by hand.


def _grid_laplacian(dims: tuple[int, ...]) -> CSR:
    """(2*ndim)+1-point Laplacian on a regular grid: diag = 2*ndim,
    nearest-neighbour off-diagonals = -1.  Symmetric, irreducibly
    diagonally dominant with positive diagonal => SPD."""
    n = int(np.prod(dims))
    idx = np.arange(n)
    coords = []
    rem = idx
    for d in dims:                      # x fastest, matching poisson2d_ic0
        coords.append(rem % d)
        rem = rem // d
    rows = [idx]
    cols = [idx]
    vals = [np.full(n, 2.0 * len(dims))]
    stride = 1
    for axis, d in enumerate(dims):
        has_prev = idx[coords[axis] > 0]
        for r, c in ((has_prev, has_prev - stride),
                     (has_prev - stride, has_prev)):
            rows.append(r)
            cols.append(c)
            vals.append(np.full(r.shape[0], -1.0))
        stride *= d
    return from_coo(np.concatenate(rows), np.concatenate(cols),
                    np.concatenate(vals), (n, n), sum_duplicates=False)


def poisson2d_spd(nx: int, ny: int) -> CSR:
    """5-point Laplacian on an nx*ny grid — the canonical SPD test system
    (its IC(0) factor has the poisson2d_ic0 sparsity structure)."""
    return _grid_laplacian((nx, ny))


def poisson3d_spd(nx: int, ny: int, nz: int) -> CSR:
    """7-point Laplacian on an nx*ny*nz grid (SPD)."""
    return _grid_laplacian((nx, ny, nz))


def _spd_from_strict_lower(rows: np.ndarray, cols: np.ndarray, n: int,
                           rng: np.random.Generator) -> CSR:
    """Symmetric diagonally-dominant CSR from strict-lower pattern entries.

    Mirrors the entries, draws one value per unordered pair, then sets
    diag[i] = sum_j |offdiag[i, j]| + U(1, 2): symmetric + strictly
    diagonally dominant + positive diagonal => positive definite.
    """
    vals = rng.uniform(-1.0, 1.0, size=rows.shape[0])
    r = np.concatenate([rows, cols, np.arange(n)])
    c = np.concatenate([cols, rows, np.arange(n)])
    v = np.concatenate([vals, vals, np.zeros(n)])
    abssum = np.zeros(n)
    np.add.at(abssum, rows, np.abs(vals))
    np.add.at(abssum, cols, np.abs(vals))
    v[-n:] = abssum + rng.uniform(1.0, 2.0, n)
    return from_coo(r, c, v, (n, n), sum_duplicates=True)


def random_spd(n: int, avg_offdiag: float = 3.0, seed: int = 0,
               max_back: int | None = None) -> CSR:
    """Random sparse SPD matrix (~avg_offdiag strict-lower nnz per row).

    Diagonally dominant by construction, so both `ic0` and `ilu0` factor it
    without breakdown; `max_back` bounds the bandwidth like random_lower.
    """
    rng = np.random.default_rng(seed)
    pat = random_lower(n, avg_offdiag=avg_offdiag, seed=seed,
                       max_back=max_back)
    prows = np.repeat(np.arange(n), pat.row_nnz())
    strict = pat.indices < prows
    return _spd_from_strict_lower(prows[strict], pat.indices[strict], n, rng)


def spd_from_lower(L: CSR, seed: int = 0) -> CSR:
    """SPD matrix whose strict-lower pattern equals L's strict-lower pattern.

    tril(A) then has exactly L's sparsity, so IC(0) factors of A inherit the
    level/dependency structure of the benchmark analogues (lung2_like,
    torso2_like) — the bridge from "triangular-factor generator" to
    "end-to-end preconditioned-solver benchmark".
    """
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(L.n_rows), L.row_nnz())
    strict = L.indices < rows
    return _spd_from_strict_lower(rows[strict], L.indices[strict],
                                  L.n_rows, rng)


def with_values(m: CSR, seed: int = 0) -> CSR:
    """Re-randomize values of an existing pattern (diag-dominant)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m.n_rows), m.row_nnz())
    data = _values_for(rows, m.indices, m.n_rows, rng)
    return CSR(indptr=m.indptr, indices=m.indices, data=data, shape=m.shape)


def _spread(total: int, parts: int) -> list[int]:
    base = total // parts
    rem = total - base * parts
    return [base + (1 if i < rem else 0) for i in range(parts)]
