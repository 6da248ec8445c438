"""Transformation driver: strategy -> TransformedSystem (A', T, d, levels).

The transformed system solves Lx=b for ANY b:

    c = B' @ b  where  B' = (I + T)^{-1}      (preamble; see rewrite.py)
    for each level (in order):
        x[rows] = (c[rows] - A'[rows,:] @ x) / d[rows]

The preamble has two realizations:
  * T-factor: solve (I+T)c = b — nnz(T) = #substitutions, always tractable,
    but depth = original elimination depth (cheap, tiny width).
  * materialized B': a dependency-free SpMV — fully parallel, but B' rows can
    be large for long rewrite distances (the paper hides this by baking the
    numeric b into generated code; Table-I costs charge neither, and we report
    `operator_total_cost_after` so the any-b overhead is visible).

Two level assignments are carried:
  * `assigned`  — the paper's bookkeeping (rows land exactly on their target
    level; emptied levels deleted).  Used for Table-I-comparable metrics.
  * `recomputed` — true dependency levels of A' (never more levels than
    assigned; rows whose deps were fully eliminated drop to level 0).  Used by
    the solver schedule (beyond-paper freebie, flag-selectable).

The full pipeline (EquationStore -> strategy -> transform -> schedule
compiler -> engines) is documented in docs/architecture.md; per-strategy
selection guidance lives in docs/strategies.md.

Copy of `repro.core.transform` (numpy host half);
tests/test_torch_host_copy.py holds the two equal.  One difference:
`replay_transform` follows new values whose elimination lands on exact
zeros where the frozen system has fill, by keeping those zeros explicit
on the frozen pattern (the reference raises PatternMismatchError).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..sparse.csr import CSR
from ..sparse.levels import LevelSets, build_levels
from .graph import GraphView
from .resilience import PatternMismatchError
from .rewrite import EquationStore
from .strategies import Strategy, StrategyStats, strategy_label

__all__ = ["TransformedSystem", "transform", "TransformMetrics",
           "ReplayPlan", "replay_transform"]


@dataclasses.dataclass(frozen=True)
class TransformMetrics:
    strategy: str
    num_levels_before: int
    num_levels_after: int
    num_levels_recomputed: int
    avg_level_cost_before: float
    avg_level_cost_after: float
    total_level_cost_before: int
    total_level_cost_after: int
    operator_total_cost_after: int   # charges the T-factor preamble (any-b)
    rows_rewritten: int
    rows_skipped_constraint: int
    substitutions: int
    max_rewrite_distance: int
    max_abs_coef: float
    code_bytes_before: int
    code_bytes_after: int
    nnz_A: int
    nnz_T: int

    def table1_row(self) -> dict:
        b, a = self.num_levels_before, self.num_levels_after
        return {
            "strategy": self.strategy,
            "num_levels": a,
            "levels_reduction_pct": 100.0 * (b - a) / b if b else 0.0,
            "avg_level_cost": self.avg_level_cost_after,
            "avg_cost_ratio": (self.avg_level_cost_after
                               / self.avg_level_cost_before
                               if self.avg_level_cost_before else 0.0),
            "total_level_cost": self.total_level_cost_after,
            "total_cost_delta_pct": (100.0 * (self.total_level_cost_after
                                              - self.total_level_cost_before)
                                     / self.total_level_cost_before),
            "code_MB": self.code_bytes_after / 1e6,
            "rows_rewritten": self.rows_rewritten,
        }


@dataclasses.dataclass(frozen=True)
class ReplayPlan:
    """Frozen transformation decisions, for pattern-frozen refactorization.

    A strategy's decisions — which rows move and to which target level, in
    which order — depend on the sparsity pattern (and, for the constrained
    strategy, on coefficient magnitudes, which is why the plan records the
    *outcome*, not the policy).  Replaying exactly these commits against a
    same-pattern matrix with new values re-runs only the numeric
    elimination algebra: no level analysis, no strategy, no tuner.
    """
    level_of0: np.ndarray               # pre-strategy level assignment
    commits: tuple[tuple[int, int], ...]  # ordered (row, target) commits


@dataclasses.dataclass(frozen=True)
class TransformedSystem:
    """(A', T, src, d) + level schedule for the transformed solve."""
    A: CSR                      # strict-lower dependency coefficients
    T: CSR                      # entity-indexed elim factor (rewrite.py)
    src: np.ndarray             # entity -> original row
    diag: np.ndarray            # diagonal of L
    level_of_assigned: np.ndarray
    level_of_recomputed: np.ndarray
    metrics: TransformMetrics
    B: CSR | None = None        # materialized B' (optional)
    plan: ReplayPlan | None = None  # replay plan (replay_transform)

    def levelsets(self, assigned: bool = False) -> LevelSets:
        lof = self.level_of_assigned if assigned else self.level_of_recomputed
        n = lof.shape[0]
        order = np.lexsort((np.arange(n), lof))
        num = int(lof.max()) + 1 if n else 0
        counts = np.bincount(lof, minlength=num)
        ptr = np.zeros(num + 1, dtype=np.int64)
        ptr[1:] = np.cumsum(counts)
        return LevelSets(level_of=lof, order=order, level_ptr=ptr)

    def preamble(self, b: np.ndarray) -> np.ndarray:
        """c = B'b via the T-factor (unit-triangular solve over entities)."""
        if self.T.nnz == 0:
            return np.asarray(b, dtype=np.result_type(self.T.data, b)).copy()
        from .rewrite import EquationStore
        return EquationStore.preamble_from_T(self.T, self.src, b)

    @property
    def identity_preamble(self) -> bool:
        return self.T.nnz == 0


def _compact_levels(level_of: np.ndarray) -> np.ndarray:
    """Delete empty levels: relabel to consecutive ids preserving order."""
    used = np.unique(level_of)
    remap = np.zeros(used.max() + 1, dtype=np.int64) if used.size else np.zeros(0, np.int64)
    remap[used] = np.arange(used.size)
    return remap[level_of]


def _paper_costs(A: CSR, level_of: np.ndarray) -> tuple[np.ndarray, int]:
    """Per-level paper cost given strict-lower dep matrix A'."""
    deps = A.row_nnz()
    rc = 2 * deps + 1
    num = int(level_of.max()) + 1 if level_of.size else 0
    lc = np.zeros(num, dtype=np.int64)
    np.add.at(lc, level_of, rc)
    return lc, int(rc.sum())


def transform(L: CSR, strategy: Strategy, validate: bool = True,
              codegen: bool = False, materialize_b: bool = False,
              rng_seed: int = 0) -> TransformedSystem:
    if codegen:
        raise NotImplementedError(
            "transform(codegen=True): the generated-code size metric "
            "(core/codegen.py) is not part of the port yet; pass "
            "codegen=False")
    view = GraphView(L)
    store = EquationStore(L, view.levels.level_of)
    stats: StrategyStats = strategy.apply(store, view)
    A, T, src, d = store.export()

    assigned = _compact_levels(store.level_of)
    # recomputed: true dependency depth of A'
    recomputed = _recompute_levels(A)
    # invariants
    assert int(recomputed.max(initial=0)) <= int(assigned.max(initial=0)), \
        "recomputed levels must never exceed assigned"
    _check_level_validity(A, assigned)

    lc_after, total_after = _paper_costs(A, assigned)
    num_after = int(lc_after.shape[0])
    # operator cost: the T-factor preamble charges 2*nnz per applied row
    op_total = total_after + int(2 * T.nnz)

    cb_before = cb_after = 0           # codegen metric: not ported yet

    metrics = TransformMetrics(
        strategy=strategy_label(strategy),
        num_levels_before=view.num_levels,
        num_levels_after=num_after,
        num_levels_recomputed=int(recomputed.max(initial=-1)) + 1,
        avg_level_cost_before=view.avg_level_cost,
        avg_level_cost_after=total_after / max(num_after, 1),
        total_level_cost_before=view.total_cost,
        total_level_cost_after=total_after,
        operator_total_cost_after=op_total,
        rows_rewritten=stats.rows_rewritten,
        rows_skipped_constraint=stats.rows_skipped_constraint,
        substitutions=stats.substitutions,
        max_rewrite_distance=stats.max_rewrite_distance,
        max_abs_coef=stats.max_abs_coef,
        code_bytes_before=cb_before,
        code_bytes_after=cb_after,
        nnz_A=A.nnz, nnz_T=T.nnz,
    )
    B = store.materialize_b(T, src) if materialize_b else None
    plan = ReplayPlan(level_of0=view.levels.level_of.copy(),
                      commits=tuple(store.commit_log))
    ts = TransformedSystem(A=A, T=T, src=src, diag=d,
                           level_of_assigned=assigned,
                           level_of_recomputed=recomputed, metrics=metrics,
                           B=B, plan=plan)
    if validate:
        _validate_equivalence(L, ts, rng_seed)
    return ts


def replay_transform(L_new: CSR, ts: TransformedSystem,
                     where: str = "replay_transform") -> TransformedSystem:
    """Re-run a frozen transformation against new values on the same pattern.

    Replays `ts.plan` (the committed (row, target) sequence) through a fresh
    EquationStore on `L_new` — pure numeric elimination over decisions that
    are already made, so level analysis (`GraphView`/`build_levels`), the
    strategy, and validation solves are all skipped.

    The replay keeps every elimination update that lands on exactly 0 (a
    cancellation, or a product that underflows) as an explicit zero, so
    its fill follows the pattern alone, and then takes the frozen A'/T
    patterns out of it: fill the frozen build lost to its own zeros must be
    exactly 0 under the new values too.  An explicit zero coefficient
    changes no answer.  Fill outside the frozen patterns that is not 0
    (the new values miss a cancellation the frozen build had, or the
    pattern differs) would be a finite but wrong answer in the frozen
    schedule, so it raises `PatternMismatchError`.

    The caller is responsible for checking that `L_new`'s pattern matches
    the matrix `ts` was built from (`sparse.csr.same_pattern`); this
    function only has the transformed system to compare against.
    """
    plan = ts.plan
    if plan is None:
        raise ValueError(
            f"{where}: TransformedSystem carries no ReplayPlan (built before "
            "the refactorization fast path existed) — rebuild with "
            "transform()/from_csr()")
    if L_new.n_rows != ts.diag.shape[0]:
        raise PatternMismatchError(
            f"matrix has {L_new.n_rows} rows, frozen system has "
            f"{ts.diag.shape[0]}", where=where, detail="shape")
    store = EquationStore(L_new, plan.level_of0, keep_zeros=True)
    for i, target in plan.commits:
        res = store.rewrite_to_level(i, target)
        store.commit(i, target, res)
    A, T, src, d = store.export()
    A, T = _on_frozen_pattern(A, ts.A), _on_frozen_pattern(T, ts.T)
    if A is None or T is None or not np.array_equal(src, ts.src):
        raise PatternMismatchError(
            "replayed transformation produced different fill than the frozen "
            "system (an exact cancellation changed the rewritten pattern) — "
            "rebuild with transform()/from_csr()",
            where=where, detail="transformed-pattern drift")
    metrics = dataclasses.replace(ts.metrics,
                                  max_abs_coef=store.max_abs_coef_seen)
    B = store.materialize_b(T, src) if ts.B is not None else None
    return dataclasses.replace(ts, A=A, T=T, src=src, diag=d,
                               metrics=metrics, B=B)


def _on_frozen_pattern(X: CSR, F: CSR) -> CSR | None:
    """X's values on F's pattern, or None unless F's entries are all in X
    and X's other entries are exactly 0.  Both are row-major with sorted
    columns (`from_coo`), so entry order follows the (row, col) keys."""
    from ..sparse.csr import same_pattern
    if same_pattern(X, F):
        return X
    if X.shape != F.shape:
        return None
    ncols = np.int64(X.shape[1])
    xkeys = np.repeat(np.arange(X.n_rows, dtype=np.int64),
                      X.row_nnz()) * ncols + X.indices
    fkeys = np.repeat(np.arange(F.n_rows, dtype=np.int64),
                      F.row_nnz()) * ncols + F.indices
    pos = np.searchsorted(xkeys, fkeys)
    if np.any(pos >= xkeys.size) or \
            not np.array_equal(xkeys[np.minimum(pos, xkeys.size - 1)], fkeys):
        return None
    rest = np.ones(X.nnz, dtype=bool)
    rest[pos] = False
    if np.any(X.data[rest] != 0.0):
        return None
    return CSR(indptr=F.indptr.copy(), indices=F.indices.copy(),
               data=X.data[pos], shape=F.shape)


def _strict_lower_csr(L: CSR) -> CSR:
    from ..sparse.csr import tril
    return tril(L, keep_diagonal=False)


def _recompute_levels(A: CSR) -> np.ndarray:
    """Dependency depth over A' (strict lower by construction — substitution
    only reaches earlier rows)."""
    assert A.nnz == 0 or bool((A.indices < np.repeat(
        np.arange(A.n_rows), A.row_nnz())).all()), "A' not strict lower"
    lv = build_levels(_with_diag(A))
    return lv.level_of


def _with_diag(A: CSR) -> CSR:
    """A' + unit diagonal so the level-set builder (which expects a full
    triangular matrix) applies."""
    from ..sparse.csr import from_coo
    rows = np.repeat(np.arange(A.n_rows), A.row_nnz())
    rows = np.concatenate([rows, np.arange(A.n_rows)])
    cols = np.concatenate([A.indices, np.arange(A.n_rows)])
    vals = np.concatenate([A.data, np.ones(A.n_rows)])
    return from_coo(rows, cols, vals, A.shape, sum_duplicates=False)


def _check_level_validity(A: CSR, level_of: np.ndarray) -> None:
    """Every dependency must live at a strictly lower level."""
    rows = np.repeat(np.arange(A.n_rows), A.row_nnz())
    if rows.size:
        assert (level_of[A.indices] < level_of[rows]).all(), \
            "level assignment violates dependencies"


def _validate_equivalence(L: CSR, ts: TransformedSystem, seed: int) -> None:
    """Transformed solve == original solve for random b (forward subst)."""
    from ..solver.reference import solve_csr_seq, solve_transformed_seq
    rng = np.random.default_rng(seed)
    b = rng.standard_normal(L.n_rows)
    x0 = solve_csr_seq(L, b)
    x1 = solve_transformed_seq(ts, b)
    scale = np.maximum(1.0, np.abs(x0).max())
    err = np.abs(x0 - x1).max() / scale
    assert err < 1e-8, f"transform changed the solution: rel err {err:.3e}"
