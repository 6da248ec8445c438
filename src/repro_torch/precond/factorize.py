"""Numeric incomplete factorization on CSR: IC(0) and ILU(0).

Copy of `repro.precond.factorize` (numpy host code);
tests/test_torch_precond.py holds the factors of the two equal, array for
array.

This is the missing producer side of the paper's motivating scenario —
"SpTRSV is a building block to preconditioners for sparse iterative
solvers".  Everything downstream of this module already exists (transform
strategies, the width-bucketed schedule compiler, the engine registry, the
cached `TriangularOperator`); this module turns a user's *system matrix*
into the triangular factor(s) those layers consume:

    fac = ic0(A)      # SPD A            ->  L with pattern tril(A), A ~ L L^T
    fac = ilu0(A)     # general square A ->  unit-L and U on A's pattern

Both use the zero-fill ("level 0") pattern: the factor keeps exactly the
input's sparsity, which is what makes the preconditioner's triangular
solves as cheap as one SpMV — and what makes them SpTRSVs worth
transforming.

Vectorized up-looking sweeps
============================
Classic up-looking IC(0)/ILU(0) is a doubly-nested per-row/per-entry loop.
Here the sweep is vectorized with the same machinery the solver uses for
execution: the dependency DAG of the factor's strict-lower pattern is cut
into level sets (`sparse.levels.build_levels`), rows within a level are
numerically independent, and the only remaining order is *within* a row —
entry t of a row needs entries 0..t-1 of the same row.  So the sweep runs
`level x wave` — wave t updates the t-th strict-lower entry of every row of
the level at once — and every numeric statement is a flat numpy gather /
scatter over precomputed index arrays (built once from the pattern, O(pair
count), reused across diagonal-shift retries).

Breakdown & diagonal shifting
=============================
IC(0) breaks down when a pivot `A[i,i] - sum_k L[i,k]^2` is not positive
(possible even for SPD A), ILU(0) when a pivot `U[k,k]` is ~0.  Following
Manteuffel's shifted incomplete factorization, on breakdown the sweep
restarts on `A + alpha * diag(|A|)` with `alpha` growing geometrically from
`shift0` until the factorization completes; `FactorResult.shift` records
the alpha actually needed (0.0 in the common diagonally-dominant case).
`max_shift_attempts=0` disables shifting — breakdown then raises
`FactorizationBreakdown`.  Both factorizations share one declarative
ladder — `core.resilience.RetryPolicy(max_attempts=max_shift_attempts,
scale0=shift0)` — so the retry semantics cannot drift between them.

`ic0` validates its input (symmetric pattern + values, positive diagonal)
and rejects non-SPD-shaped matrices with a ValueError; pass
`check_symmetric=False` to skip the O(nnz) check for trusted inputs.

The `Preconditioner` facade in `precond.api` wires these factors into
paired `TriangularOperator`s (README.md shows the PCG path).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.resilience import PatternMismatchError, RetryPolicy
from ..sparse.csr import CSR, from_coo, same_pattern, tril
from ..sparse.levels import build_levels

__all__ = ["FactorResult", "FactorizationBreakdown", "ic0", "ilu0",
           "refactor", "factors_from_numpy"]


class FactorizationBreakdown(RuntimeError):
    """Incomplete factorization hit a non-positive / ~zero pivot and
    diagonal shifting was disabled or exhausted."""


@dataclasses.dataclass(frozen=True)
class FactorResult:
    """Output of ic0/ilu0: the factor(s) plus breakdown bookkeeping.

    kind:     "ic0" or "ilu0".
    L:        lower-triangular CSR factor, diagonal included.  For ic0 this
              is the incomplete Cholesky factor (A ~ L L^T); for ilu0 the
              unit-lower factor with its 1.0 diagonal stored explicitly.
    U:        upper-triangular CSR factor for ilu0 (A ~ L U); None for ic0
              (the backward sweep solves with L^T via transpose=True).
    shift:    the diagonal shift alpha that made the factorization succeed
              (0.0 when no breakdown occurred).
    attempts: number of factorization sweeps run (1 = no breakdown).
    plan:     the pattern-only preprocessing (_IC0Plan / _ILU0Plan) the
              numeric sweep ran over.  Kept so `refactor` can re-run the
              sweep for new values on the same pattern without re-deriving
              the index arrays (the refactorization fast path,
              docs/refactorization.md).
    """

    kind: str
    L: CSR
    U: CSR | None
    shift: float
    attempts: int
    plan: object | None = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def n(self) -> int:
        return self.L.n_rows

    def __repr__(self) -> str:  # pragma: no cover
        return (f"FactorResult(kind={self.kind!r}, n={self.n}, "
                f"nnz_L={self.L.nnz}, "
                f"nnz_U={self.U.nnz if self.U is not None else None}, "
                f"shift={self.shift}, attempts={self.attempts})")


# -- pattern analysis (shared by both factorizations) -------------------------


def _ragged_arange(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Concatenate [arange(s, s+c) for s, c in zip(starts, counts)]."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    rep_starts = np.repeat(starts, counts)
    offs = np.repeat(np.cumsum(counts) - counts, counts)
    return rep_starts + (np.arange(total) - offs)


def _positions_of(pat: CSR, rows: np.ndarray, cols: np.ndarray):
    """(positions, found) of entries (rows[i], cols[i]) in pat's data order.

    CSR with sorted rows makes the composite key `row * n_cols + col`
    globally ascending, so membership is one searchsorted over all queries.
    """
    prow = np.repeat(np.arange(pat.n_rows), pat.row_nnz())
    comp = prow * pat.n_cols + pat.indices
    key = rows * pat.n_cols + cols
    pos = np.searchsorted(comp, key)
    pos_c = np.minimum(pos, comp.shape[0] - 1)
    found = (pos < comp.shape[0]) & (comp[pos_c] == key)
    return pos_c, found


def _diag_positions(pat: CSR, what: str) -> np.ndarray:
    """Position of each row's diagonal entry; every row must have one."""
    n = pat.n_rows
    pos, found = _positions_of(pat, np.arange(n), np.arange(n))
    if not found.all():
        missing = int(np.flatnonzero(~found)[0])
        raise ValueError(f"{what}: row {missing} has no diagonal entry in "
                         f"the sparsity pattern (zero-fill factorization "
                         f"needs a full diagonal)")
    return pos


def _check_symmetric(A: CSR, rtol: float = 1e-10) -> None:
    """Reject matrices that cannot be SPD: asymmetric pattern or values,
    or a non-positive diagonal entry."""
    if A.n_rows != A.n_cols:
        raise ValueError(f"ic0 needs a square matrix, got {A.shape}")
    At = A.transpose()
    sym = (A.indptr.shape == At.indptr.shape
           and np.array_equal(A.indptr, At.indptr)
           and np.array_equal(A.indices, At.indices)
           and np.allclose(A.data, At.data,
                           rtol=rtol, atol=rtol * max(1.0, float(
                               np.abs(A.data).max(initial=0.0)))))
    if not sym:
        raise ValueError(
            "ic0 needs a symmetric (SPD) matrix: pattern or values are not "
            "symmetric.  Pass the FULL matrix, not a triangle (see "
            "sparse.generators.poisson2d_spd / random_spd); use ilu0 for "
            "general square matrices.")
    d = A.diagonal_fast()
    if (d <= 0).any():
        i = int(np.flatnonzero(d <= 0)[0])
        raise ValueError(f"ic0: diagonal entry {i} is {d[i]:g} <= 0 — the "
                         f"matrix cannot be SPD")


def _shifted(pat_vals: np.ndarray, dpos: np.ndarray, alpha: float,
             base: np.ndarray) -> np.ndarray:
    """Values with the diagonal shifted: d += alpha * base."""
    vals = pat_vals.copy()
    vals[dpos] += alpha * base
    return vals


def _row_scale(pat: CSR, vals: np.ndarray) -> np.ndarray:
    """max |value| per row — the magnitude pivots are compared against.

    Scaling breakdown checks by the row (not the diagonal itself) matters:
    a ~zero diagonal in a row of O(1) entries must count as breakdown, and
    `d <= rtol * |d|` never fires.
    """
    # every row is non-empty (diagonal presence is validated first)
    return np.maximum.reduceat(np.abs(vals), pat.indptr[:-1])


def _shift_base(diag: np.ndarray, amax: float) -> np.ndarray:
    """Per-row shift unit: |A_ii|, or the matrix scale where the diagonal
    is degenerate (shifting a ~zero diagonal by multiples of itself would
    never cure the breakdown)."""
    base = np.abs(diag)
    floor = 1e-8 * max(amax, 1e-300)
    return np.where(base > floor, base, max(amax, 1.0))


def _wave_of(pat: CSR) -> tuple[np.ndarray, np.ndarray]:
    """(local index of each entry within its row, row id of each entry)."""
    rows = np.repeat(np.arange(pat.n_rows), pat.row_nnz())
    return np.arange(pat.nnz) - pat.indptr[rows], rows


# -- IC(0) --------------------------------------------------------------------


class _IC0Plan:
    """Pattern-only preprocessing for IC(0) on `low = tril(A)`.

    For every strict-lower entry p = (i, j), the update term is
    sum over k in cols(i) /\\ cols(j), k < j of L[i,k] * L[j,k]; the plan
    stores one (p, q, t) triple per product, where q is the position of
    L[i,k] (same row, earlier wave) and t the position of L[j,k] (earlier
    level, final).  Triples are bucketed by the (level, wave) at which q
    becomes final, so the numeric sweep scatter-adds each product exactly
    once, right after its q is computed.
    """

    def __init__(self, low: CSR):
        self.low = low
        n = low.n_rows
        self.dpos = _diag_positions(low, "ic0")
        if not (low.indices[self.dpos] == np.arange(n)).all():
            raise AssertionError("tril pattern must end rows on the diagonal")
        self.levels = build_levels(low)
        wave, rows = _wave_of(low)
        self.wave, self.rows_of = wave, rows
        self.n_off_of_row = low.row_nnz() - 1   # diag is each row's last
        offdiag = np.flatnonzero(low.indices < rows)        # strict lower
        self.offdiag = offdiag
        # candidate products: q runs over the entries of row(p) before p
        counts = wave[offdiag]                               # q-count per p
        pp = np.repeat(offdiag, counts)
        qq = _ragged_arange(low.indptr[rows[offdiag]], counts)
        jj = low.indices[pp]                                 # col of p
        kk = low.indices[qq]                                 # col of q
        tt, found = _positions_of(low, jj, kk)               # L[j, k]?
        pp, qq, tt = pp[found], qq[found], tt[found]
        # bucket by (level of q's row, wave of q): ready-order of q
        lvl_q = self.levels.level_of[rows[qq]]
        key = lvl_q * (int(wave.max(initial=0)) + 1) + wave[qq]
        order = np.argsort(key, kind="stable")
        self.pp, self.qq, self.tt = pp[order], qq[order], tt[order]
        self.key_sorted = key[order]

    def entries_at(self, lvl: int, w: int) -> np.ndarray:
        """Strict-lower positions at wave w of level lvl's rows."""
        rows = self.levels.rows_in_level(lvl)
        rows = rows[self.n_off_of_row[rows] > w]        # rows deep enough
        return self.low.indptr[rows] + w

    def pairs_at(self, lvl: int, w: int):
        key = lvl * self.max_wave_key + w
        lo = np.searchsorted(self.key_sorted, key)
        hi = np.searchsorted(self.key_sorted, key + 1)
        return self.pp[lo:hi], self.qq[lo:hi], self.tt[lo:hi]

    @property
    def max_wave_key(self) -> int:
        return int(self.wave.max(initial=0)) + 1


def _ic0_sweep(plan: _IC0Plan, vals: np.ndarray,
               breakdown_rtol: float) -> np.ndarray:
    """One numeric IC(0) pass over shifted input values `vals` (in tril
    pattern order).  Returns factor values or raises FactorizationBreakdown.
    """
    low, dpos = plan.low, plan.dpos
    data = np.zeros_like(vals)
    acc = np.zeros_like(vals)           # accumulated sum_k L[i,k] L[j,k]
    scale = _row_scale(low, vals)
    for lvl in range(plan.levels.num_levels):
        rows = plan.levels.rows_in_level(lvl)
        depth = int(plan.n_off_of_row[rows].max(initial=0))
        for w in range(depth):
            p = plan.entries_at(lvl, w)
            data[p] = (vals[p] - acc[p]) / data[dpos[low.indices[p]]]
            pp, qq, tt = plan.pairs_at(lvl, w)
            if pp.size:
                np.add.at(acc, pp, data[qq] * data[tt])
        # diagonal: d_i^2 = A[i,i] - sum_k L[i,k]^2
        sq = np.zeros(rows.shape[0])
        lo, hi = low.indptr[rows], plan.dpos[rows]
        seg = _ragged_arange(lo, hi - lo)
        np.add.at(sq, np.repeat(np.arange(rows.shape[0]), hi - lo),
                  data[seg] ** 2)
        d2 = vals[dpos[rows]] - sq
        bad = d2 <= breakdown_rtol * scale[rows]
        if bad.any():
            i = int(rows[np.flatnonzero(bad)[0]])
            raise FactorizationBreakdown(
                f"ic0: non-positive pivot at row {i} "
                f"(d^2 = {d2[np.flatnonzero(bad)[0]]:.3e})")
        data[dpos[rows]] = np.sqrt(d2)
    return data


def ic0(A: CSR, *, shift0: float = 1e-3, max_shift_attempts: int = 20,
        breakdown_rtol: float = 1e-12,
        check_symmetric: bool = True) -> FactorResult:
    """Incomplete Cholesky with zero fill: L on tril(A)'s pattern, A ~ L L^T.

    A:        the FULL symmetric positive-definite matrix (both triangles).
    shift0:   first diagonal shift tried after a breakdown; doubles per
              retry (Manteuffel shifting, see module doc).
    max_shift_attempts: retries before giving up (0 disables shifting).
    breakdown_rtol:     pivot d^2 <= rtol * |A[i,i]| counts as breakdown.
    check_symmetric:    reject asymmetric / non-positive-diagonal input.

    Returns a FactorResult with `L` (diagonal included) and `U=None`; apply
    the preconditioner as M^-1 = (L L^T)^-1 via a forward solve with L and a
    backward solve with transpose=True (precond.Preconditioner does
    exactly this over cached TriangularOperators).
    """
    if check_symmetric:
        _check_symmetric(A)
    elif A.n_rows != A.n_cols:
        raise ValueError(f"ic0 needs a square matrix, got {A.shape}")
    low = tril(A)
    plan = _IC0Plan(low)
    base = _shift_base(low.data[plan.dpos],
                       float(np.abs(low.data).max(initial=0.0)))
    data, alpha, attempts = RetryPolicy(
        max_attempts=max_shift_attempts, scale0=shift0).run(
        lambda a: _ic0_sweep(plan, _shifted(low.data, plan.dpos, a, base),
                             breakdown_rtol),
        retry_on=(FactorizationBreakdown,))
    L = CSR(indptr=low.indptr, indices=low.indices, data=data,
            shape=low.shape)
    return FactorResult(kind="ic0", L=L, U=None, shift=alpha,
                        attempts=attempts, plan=plan)


# -- ILU(0) -------------------------------------------------------------------


class _ILU0Plan:
    """Pattern-only preprocessing for ILU(0) on A's full pattern.

    Row-wise IKJ elimination: for row i, for each strict-lower position
    p = (i, k) in column order, `w[k] /= U[k,k]` then `w[j] -= w[k] U[k,j]`
    for every j > k present in BOTH row k (upper part) and row i.  The plan
    stores one (p, u, tgt) triple per such update — u the position of
    U[k,j], tgt the position of (i,j) — bucketed by p's wave (its local
    index among row i's strict-lower entries), because row k lives in an
    earlier level and is final when row i is processed.
    """

    def __init__(self, pat: CSR):
        if pat.n_rows != pat.n_cols:
            raise ValueError(f"ilu0 needs a square matrix, got {pat.shape}")
        self.pat = pat
        n = pat.n_rows
        self.dpos = _diag_positions(pat, "ilu0")
        _, rows = _wave_of(pat)
        self.rows_of = rows
        lower = np.flatnonzero(pat.indices < rows)
        self.lower = lower
        self.lower_wave = lower - pat.indptr[rows[lower]]  # cols sorted =>
        #                      strict-lower entries are the row's first ones
        self.levels = build_levels(tril(pat))
        # update triples for each lower entry p = (i, k)
        kk = pat.indices[lower]
        u_lo = self.dpos[kk] + 1                 # upper entries of row k
        u_hi = pat.indptr[kk + 1]
        counts = u_hi - u_lo
        pp = np.repeat(lower, counts)
        uu = _ragged_arange(u_lo, counts)
        jj = pat.indices[uu]
        tgt, found = _positions_of(pat, rows[pp], jj)
        pp, uu, tgt = pp[found], uu[found], tgt[found]
        lvl_p = self.levels.level_of[rows[pp]]
        self.max_wave_key = int(self.lower_wave.max(initial=0)) + 1
        key = lvl_p * self.max_wave_key + (pp - pat.indptr[rows[pp]])
        order = np.argsort(key, kind="stable")
        self.pp, self.uu, self.tgt = pp[order], uu[order], tgt[order]
        self.key_sorted = key[order]
        self.n_lower_of_row = self.dpos - pat.indptr[:-1]  # strict-lower count

    def entries_at(self, lvl: int, w: int) -> np.ndarray:
        rows = self.levels.rows_in_level(lvl)
        rows = rows[self.n_lower_of_row[rows] > w]
        return self.pat.indptr[rows] + w

    def updates_at(self, lvl: int, w: int):
        key = lvl * self.max_wave_key + w
        lo = np.searchsorted(self.key_sorted, key)
        hi = np.searchsorted(self.key_sorted, key + 1)
        return self.pp[lo:hi], self.uu[lo:hi], self.tgt[lo:hi]


def _ilu0_sweep(plan: _ILU0Plan, vals: np.ndarray,
                breakdown_rtol: float) -> np.ndarray:
    """One numeric ILU(0) pass; `vals` in A's pattern order (shifted).
    Factors in place: on return, strict-lower positions hold L (unit
    diagonal implicit), diagonal + upper positions hold U."""
    pat, dpos = plan.pat, plan.dpos
    data = vals.copy()
    scale = _row_scale(pat, vals)
    for lvl in range(plan.levels.num_levels):
        rows = plan.levels.rows_in_level(lvl)
        depth = int(plan.n_lower_of_row[rows].max(initial=0))
        for w in range(depth):
            p = plan.entries_at(lvl, w)
            k = pat.indices[p]
            data[p] = data[p] / data[dpos[k]]
            pp, uu, tgt = plan.updates_at(lvl, w)
            if pp.size:
                # one eliminating entry per row per wave => tgt disjoint
                data[tgt] = data[tgt] - data[pp] * data[uu]
        d = data[dpos[rows]]
        bad = np.abs(d) <= breakdown_rtol * scale[rows]
        if bad.any():
            i = int(rows[np.flatnonzero(bad)[0]])
            raise FactorizationBreakdown(
                f"ilu0: ~zero pivot at row {i} (U[{i},{i}] = "
                f"{d[np.flatnonzero(bad)[0]]:.3e})")
    return data


def ilu0(A: CSR, *, shift0: float = 1e-3, max_shift_attempts: int = 20,
         breakdown_rtol: float = 1e-14) -> FactorResult:
    """Incomplete LU with zero fill on A's pattern: A ~ L U, L unit-lower.

    Up-looking IKJ elimination restricted to A's sparsity (no fill-in):
    the defining property is (L U)[i, j] == A[i, j] exactly for every
    (i, j) in A's pattern.  Breakdown (a ~zero pivot) triggers the same
    geometric diagonal-shift retry as `ic0`.

    Returns a FactorResult with `L` (unit diagonal stored explicitly, so
    it solves through the standard lower operator) and `U` (diagonal
    included, solved with side="upper").
    """
    plan = _ILU0Plan(A)
    base = _shift_base(A.data[plan.dpos],
                       float(np.abs(A.data).max(initial=0.0)))
    data, alpha, attempts = RetryPolicy(
        max_attempts=max_shift_attempts, scale0=shift0).run(
        lambda a: _ilu0_sweep(plan, _shifted(A.data, plan.dpos, a, base),
                              breakdown_rtol),
        retry_on=(FactorizationBreakdown,))
    L, U = _ilu0_split(A, data)
    return FactorResult(kind="ilu0", L=L, U=U, shift=alpha,
                        attempts=attempts, plan=plan)


def _ilu0_split(pat: CSR, data: np.ndarray) -> tuple[CSR, CSR]:
    """Split in-place-factored values (strict-lower = L, diag+upper = U)
    into the two triangular factor CSRs."""
    n = pat.n_rows
    rows = np.repeat(np.arange(n), pat.row_nnz())
    low_mask = pat.indices < rows
    up_mask = pat.indices >= rows
    L = from_coo(np.concatenate([rows[low_mask], np.arange(n)]),
                 np.concatenate([pat.indices[low_mask], np.arange(n)]),
                 np.concatenate([data[low_mask], np.ones(n)]),
                 pat.shape, sum_duplicates=False)
    U = from_coo(rows[up_mask], pat.indices[up_mask], data[up_mask],
                 pat.shape, sum_duplicates=False)
    return L, U


# -- pattern-frozen refactorization -------------------------------------------


def refactor(fac: FactorResult, A_new: CSR, *, shift0: float = 1e-3,
             max_shift_attempts: int = 20,
             breakdown_rtol: float | None = None) -> FactorResult:
    """Numeric-only re-factorization of a new matrix on the SAME pattern.

    Re-runs the vectorized ic0/ilu0 value sweep over the pattern plan
    already carried by `fac` — level sets, update-pair index arrays and
    diagonal positions are all reused untouched, so per time-step cost is
    the numeric sweep alone.  The diagonal-shift retry ladder applies as in
    the fresh factorization (each refactorization gets its own shift).

    A_new whose pattern differs from the frozen one — for ic0 the pattern
    of tril(A_new), for ilu0 the full pattern — raises a typed
    PatternMismatchError: rebuild with ic0()/ilu0() instead.  A `fac`
    without a plan (e.g. unpickled from an old artifact) raises ValueError.

    breakdown_rtol: None picks the kind's fresh-factorization default
    (1e-12 for ic0, 1e-14 for ilu0).

    Values are NOT re-validated for symmetry (ic0's SPD check): the
    pattern is frozen and per-step inputs are trusted — pass A_new through
    `ic0(A_new)` if it needs the full validation.
    """
    plan = fac.plan
    if plan is None:
        raise ValueError(
            f"FactorResult(kind={fac.kind!r}) carries no pattern plan "
            "(stale artifact?) — run ic0()/ilu0() on the new matrix instead")
    where = f"refactor[{fac.kind}](n={fac.n})"
    if fac.kind == "ic0":
        rtol = 1e-12 if breakdown_rtol is None else breakdown_rtol
        low = tril(A_new)
        if not same_pattern(low, plan.low):
            raise PatternMismatchError(
                "tril(A_new) pattern differs from the frozen ic0 pattern; "
                "re-run ic0()", where=where, detail="lower-triangle drift")
        base = _shift_base(low.data[plan.dpos],
                           float(np.abs(low.data).max(initial=0.0)))
        data, alpha, attempts = RetryPolicy(
            max_attempts=max_shift_attempts, scale0=shift0).run(
            lambda a: _ic0_sweep(plan, _shifted(low.data, plan.dpos, a, base),
                                 rtol),
            retry_on=(FactorizationBreakdown,))
        L = CSR(indptr=low.indptr, indices=low.indices, data=data,
                shape=low.shape)
        return FactorResult(kind="ic0", L=L, U=None, shift=alpha,
                            attempts=attempts, plan=plan)
    if fac.kind == "ilu0":
        rtol = 1e-14 if breakdown_rtol is None else breakdown_rtol
        if not same_pattern(A_new, plan.pat):
            raise PatternMismatchError(
                "A_new pattern differs from the frozen ilu0 pattern; "
                "re-run ilu0()", where=where, detail="pattern drift")
        base = _shift_base(A_new.data[plan.dpos],
                           float(np.abs(A_new.data).max(initial=0.0)))
        data, alpha, attempts = RetryPolicy(
            max_attempts=max_shift_attempts, scale0=shift0).run(
            lambda a: _ilu0_sweep(plan,
                                  _shifted(A_new.data, plan.dpos, a, base),
                                  rtol),
            retry_on=(FactorizationBreakdown,))
        L, U = _ilu0_split(A_new, data)
        return FactorResult(kind="ilu0", L=L, U=U, shift=alpha,
                            attempts=attempts, plan=plan)
    raise ValueError(f"unknown factorization kind {fac.kind!r}")


# -- carrying factors across --------------------------------------------------


def factors_from_numpy(kind: str, L_arrays, U_arrays, shift: float,
                       attempts: int) -> FactorResult:
    """A FactorResult from plain arrays, as `solver.levelset.
    schedule_from_numpy` carries a schedule across: `L_arrays` and
    `U_arrays` are (indptr, indices, data) of square factors (`U_arrays`
    None for ic0).  Arrays are copied; the result carries no pattern plan,
    so `refactor` refuses it.
    """
    if kind not in ("ic0", "ilu0"):
        raise ValueError(f"unknown factorization kind {kind!r}")
    if (U_arrays is None) != (kind == "ic0"):
        raise ValueError(f"{kind} takes {'no' if kind == 'ic0' else 'a'} "
                         f"U factor")

    def csr(arrays):
        indptr, indices, data = (np.array(a, copy=True) for a in arrays)
        n = indptr.shape[0] - 1
        return CSR(indptr=indptr, indices=indices, data=data, shape=(n, n))

    return FactorResult(kind=kind, L=csr(L_arrays),
                        U=None if U_arrays is None else csr(U_arrays),
                        shift=float(shift), attempts=int(attempts))
