"""Equation-rewriting engine (paper §II.B) with rearrangement.

Canonical row form (semantics of the triple (A, B, d)):

    d_i * x_i + sum_l A[i,l] * x_l  =  sum_k B[i,k] * b_k
    =>  x_i = ( B_i . b  -  A_i . x ) / d_i

The original system Lx=b is the special case A = strict-lower(L), B = I.

Substituting a dependency x_j out of row i ("rewriting", paper Fig. 2) with
rearrangement (grouping common multipliers — paper §II.B) is one exact sparse
elimination step with multiplier s = A[i,j]/d_j:

    A[i,l] -= s * A[j,l]     (A[i,j] -> 0)
    B[i,k] -= s * B[j,k]

Representation choice (performance-critical): the x-side (A) is materialized
eagerly — it is what the paper's cost model measures — while the b-side is
recorded as one-step *elimination pairs* (j, s).  Stacked, the pairs form a
strictly-lower-triangular factor T with

    B' = (I + T)^{-1}        (unit-triangular inverse)

so the solve preamble c = B'b is itself a cheap sparse triangular solve
(I+T)c = b with nnz(T) = number of substitutions.  B' rows can optionally be
materialized (`materialize_b`) when rewrite distances are modest; for
unbounded faithful runs on torso2-scale graphs B' rows are dense-ish and the
T-factor path is the only tractable one.  The paper's own prototype sidesteps
this entirely by baking the numeric b into generated code — our codegen
reproduces that for the code-size metric (see codegen.py).

Expansion closures are memoized per target cutoff (the paper's "costMap" made
exact): rewrite(j, target) — row j's equation with all deps < target — is
mathematically unique no matter when it is computed (substitution is exact
algebra and rows only move to earlier levels), so entries never go stale
within one cutoff.

Copy of `repro.core.rewrite` (numpy host half);
tests/test_torch_host_copy.py holds the two equal.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..sparse.csr import CSR

__all__ = ["EquationStore", "RewriteResult"]


@dataclasses.dataclass
class RewriteResult:
    """Outcome of a tentative rewrite of one row to a target level."""
    A: dict[int, float]
    elim: list[tuple[int, float]]   # one-step elimination pairs (row, s)
    n_subs: int                     # substitutions in this expansion
    max_abs_coef: float             # max |A coefficient| (stability proxy)

    @property
    def paper_cost(self) -> int:
        return 2 * len(self.A) + 1

    @property
    def indegree(self) -> int:
        return len(self.A)


class EquationStore:
    """Current equations of the system being transformed.

    Unmodified rows are materialized lazily from the CSR matrix; rewritten
    rows live in python dicts.  `level_of` is the *current* level assignment
    (mutated by strategies as rows move).
    """

    def __init__(self, L: CSR, level_of: np.ndarray):
        self.L = L
        self.diag = L.diagonal_fast()
        if np.any(self.diag == 0):
            raise ValueError("zero diagonal — not a valid triangular system")
        self.level_of = level_of.copy()
        self._rew_A: dict[int, dict[int, float]] = {}
        # Persisted elimination recursion (the T-factor), entity-indexed.
        # Entities 0..n-1 are the original rows; auxiliary entities (one per
        # (closure node, cutoff) pair — a node expanded under two different
        # target cutoffs has two *different* valid (A, b-combination) forms,
        # so each cutoff gets its own entity) are appended after.
        self._ent_elim: dict[int, list[tuple[int, float]]] = {}  # ent -> pairs
        self._aux_src: list[int] = []                 # aux entity -> src row
        self._aux_index: dict[tuple, int] = {}        # (row, cutoff) -> ent
        self._commit_version: dict[int, int] = {}     # row -> re-commit count
        self.rows_rewritten: set[int] = set()
        # memoized expansion closures, keyed per target cutoff (paper costMap)
        self._memo: dict[int, tuple[dict, list]] = {}
        self._memo_target: int = -1
        self._memo_subs: int = 0
        self.total_subs = 0
        self.max_rewrite_distance = 0
        self.max_abs_coef_seen = float(np.abs(L.data).max()) if L.nnz else 0.0
        # ordered (row, target) commit log — the pattern-frozen replay plan:
        # re-running exactly these commits against a matrix with the same
        # pattern (new values) reproduces the transformation numerically
        # without consulting any strategy (core.transform.replay_transform)
        self.commit_log: list[tuple[int, int]] = []

    # -- row access ----------------------------------------------------------
    def deps(self, i: int) -> dict[int, float]:
        """Strict-lower coefficients of row i (current equation)."""
        got = self._rew_A.get(i)
        if got is not None:
            return got
        cols, vals = self.L.row(i)
        return {int(c): float(v) for c, v in zip(cols, vals) if c != i}

    def indegree(self, i: int) -> int:
        got = self._rew_A.get(i)
        if got is not None:
            return len(got)
        return int(self.L.indptr[i + 1] - self.L.indptr[i]) - 1

    def row_paper_cost(self, i: int) -> int:
        return 2 * self.indegree(i) + 1

    # -- rewriting -----------------------------------------------------------
    def rewrite_to_level(self, i: int, target: int) -> RewriteResult:
        """Tentatively rewrite row i so all remaining deps have level < target.

        Does NOT commit; call `commit` with the result to apply.
        """
        if self._memo_target != target:
            self._memo = {}
            self._memo_target = target
        before = self._memo_subs
        A, elim = self._expand(i, target, memoize_root=False)
        n_subs = self._memo_subs - before
        mx = max((abs(v) for v in A.values()), default=0.0)
        return RewriteResult(A=A, elim=elim, n_subs=n_subs, max_abs_coef=mx)

    def _expand(self, root: int, target: int, memoize_root: bool = True):
        """(A, elim) of row `root` with all deps at level < target.

        Iterative post-order over the >=target dependency closure with an
        explicit stack (chains can be hundreds of levels deep).
        """
        memo = self._memo
        got = memo.get(root)
        if got is not None:
            return dict(got[0]), got[1]
        level_of = self.level_of
        stack = [root]
        while stack:
            j = stack[-1]
            if j in memo:  # duplicate push (shared dep) — already resolved
                stack.pop()
                continue
            deps_j = self.deps(j)
            pend = [k for k in deps_j
                    if level_of[k] >= target and k not in memo]
            if pend:
                stack.extend(pend)
                continue
            stack.pop()
            A = dict(deps_j)
            elim: list[tuple[int, float]] = []
            for k in [k for k in A if level_of[k] >= target]:
                s = A.pop(k) / self.diag[k]
                elim.append((k, s))
                Ak, _ = memo[k]
                for l, a in Ak.items():
                    v = A.get(l, 0.0) - s * a
                    if v == 0.0:
                        A.pop(l, None)
                    else:
                        A[l] = v
                self._memo_subs += 1
            if j == root and not memoize_root:
                return A, elim
            memo[j] = (A, elim)
        A, elim = memo[root]
        return dict(A), elim

    def commit(self, i: int, target: int, res: RewriteResult) -> None:
        """Apply a tentative rewrite: move row i to `target`.

        Persists the elimination pairs of i and of every auxiliary closure
        node reachable from them (so the T-factor can rebuild B'b for any b
        after the transient per-target memo is gone).
        """
        dist = int(self.level_of[i]) - target
        resolved = self._resolve_pairs(res.elim, target)
        self._rew_A[i] = res.A
        # a re-commit (row rewritten again at a lower cutoff — e.g. the
        # critical-path strategy) eliminates INCREMENTALLY from the committed
        # form, so its pairs APPEND to the existing recursion
        self._ent_elim[i] = self._ent_elim.get(i, []) + resolved
        self._commit_version[i] = self._commit_version.get(i, 0) + 1
        self.level_of[i] = target
        self.rows_rewritten.add(i)
        self.commit_log.append((int(i), int(target)))
        self.total_subs += res.n_subs
        self.max_rewrite_distance = max(self.max_rewrite_distance, dist)
        self.max_abs_coef_seen = max(self.max_abs_coef_seen, res.max_abs_coef)

    def _resolve_pairs(self, elim: list[tuple[int, float]],
                       cutoff: int) -> list[tuple[int, float]]:
        """Map raw elimination pairs (row, s) to entity ids, creating
        auxiliary entities for uncommitted closure nodes at this cutoff.

        Committed rows resolve to an immutable SNAPSHOT of their current
        recursion (a strategy may re-rewrite a committed row at a lower
        cutoff later — critical-path does — which appends to the row's own
        entity; earlier references must keep the old meaning).
        """
        n = self.L.n_rows
        rew, aux, memo = self._rew_A, self._aux_index, self._memo

        def snap(k: int) -> int:
            """Immutable copy of a committed row's current recursion."""
            key = ("snap", k, self._commit_version.get(k, 0))
            ent = aux.get(key)
            if ent is None:
                ent = n + len(self._aux_src)
                aux[key] = ent
                self._aux_src.append(k)
                self._ent_elim[ent] = list(self._ent_elim.get(k, []))
            return ent

        def needs_further(k: int) -> bool:
            # a committed row eliminated at a cutoff BELOW its commit level
            # was expanded further: its aux entity must chain the committed
            # recursion with the additional eliminations
            got = memo.get(k)
            return got is not None and bool(got[1])

        def akey(k: int):
            return (k, cutoff, self._commit_version.get(k, 0))

        def ref(k: int) -> int:
            if k in rew and not needs_further(k):
                return snap(k)
            return aux[akey(k)]

        def pend_of(k: int) -> bool:
            return akey(k) not in aux and (k not in rew or needs_further(k))

        # ensure aux entities exist for the whole closure (iterative
        # post-order; chains can be hundreds of levels deep)
        stack = [k for k, _ in elim if pend_of(k)]
        while stack:
            k = stack[-1]
            if akey(k) in aux:
                stack.pop()
                continue
            pend = [kk for kk, _ in memo[k][1] if pend_of(kk)]
            if pend:
                stack.extend(pend)
                continue
            stack.pop()
            ent = n + len(self._aux_src)
            aux[akey(k)] = ent
            self._aux_src.append(k)
            base = list(self._ent_elim.get(k, [])) if k in rew else []
            self._ent_elim[ent] = base + [(ref(kk), s)
                                          for kk, s in memo[k][1]]
        return [(ref(k), s) for k, s in elim]

    # -- export ---------------------------------------------------------------
    def export(self) -> tuple[CSR, CSR, np.ndarray, np.ndarray]:
        """Assemble (A', T, src, d).

        T is the entity-indexed elimination factor: entities [0, n) are the
        original rows, entities [n, n_ent) are auxiliary (closure node,
        cutoff) pairs; `src` maps entity -> original row.  The preamble
        c = B'b solves (I+T)c = b[src] in src-ascending entity order (every
        reference points to a strictly smaller original row).
        """
        n = self.L.n_rows
        indptr, indices, data = self.L.indptr, self.L.indices, self.L.data
        # A' — vectorized fast path for untouched rows
        a_rows, a_cols, a_vals = [], [], []
        rew = self._rew_A
        for i in sorted(rew):
            got = rew[i]
            for c in sorted(got):
                a_rows.append(i); a_cols.append(c); a_vals.append(got[c])
        touched = np.zeros(n, dtype=bool)
        if rew:
            touched[np.fromiter(rew.keys(), dtype=np.int64)] = True
        all_rows = np.repeat(np.arange(n), np.diff(indptr))
        keep = (~touched[all_rows]) & (indices != all_rows)
        from ..sparse.csr import from_coo
        rows_np = np.concatenate([all_rows[keep],
                                  np.asarray(a_rows, dtype=np.int64)])
        cols_np = np.concatenate([indices[keep],
                                  np.asarray(a_cols, dtype=np.int64)])
        vals_np = np.concatenate([data[keep],
                                  np.asarray(a_vals, dtype=np.float64)])
        A = from_coo(rows_np, cols_np, vals_np, self.L.shape,
                     sum_duplicates=False)
        # T factor over entities
        n_ent = n + len(self._aux_src)
        t_rows, t_cols, t_vals = [], [], []
        for e, pairs in self._ent_elim.items():
            for k, s in pairs:
                t_rows.append(e); t_cols.append(k); t_vals.append(s)
        T = from_coo(t_rows, t_cols, t_vals, (n_ent, n_ent),
                     sum_duplicates=False)
        src = np.concatenate([np.arange(n, dtype=np.int64),
                              np.asarray(self._aux_src, dtype=np.int64)])
        return A, T, src, self.diag.copy()

    @staticmethod
    def preamble_from_T(T: CSR, src: np.ndarray, b: np.ndarray) -> np.ndarray:
        """c[:n] with (I+T)c = b[src]; processed in src-ascending order."""
        n = b.shape[0]
        c = np.asarray(b)[src].astype(np.result_type(T.data, b), copy=True)
        nz = np.flatnonzero(T.row_nnz() > 0)
        order = nz[np.argsort(src[nz], kind="stable")]
        indptr, indices, data = T.indptr, T.indices, T.data
        for e in order:
            lo, hi = indptr[e], indptr[e + 1]
            c[e] = b[src[e]] - data[lo:hi] @ c[indices[lo:hi]]
        return c[:n]

    def materialize_b(self, T: CSR, src: np.ndarray,
                      max_entries: int = 50_000_000) -> CSR:
        """B' rows = unit-triangular inverse rows of (I+T), mapped back to
        original-row space; tractable for modest rewrite distances."""
        n = self.L.n_rows
        brows: dict[int, dict[int, float]] = {}
        total = 0
        nz = np.flatnonzero(T.row_nnz() > 0)
        order = nz[np.argsort(src[nz], kind="stable")]
        from ..sparse.csr import from_coo
        for e in order:
            cols, vals = T.row(int(e))
            B = {int(src[e]): 1.0}
            for k, s in zip(cols, vals):
                Bk = brows.get(int(k))
                if Bk is None:
                    l = int(src[k])
                    v = B.get(l, 0.0) - s
                    if v == 0.0:
                        B.pop(l, None)
                    else:
                        B[l] = v
                else:
                    for l, bv in Bk.items():
                        v = B.get(l, 0.0) - s * bv
                        if v == 0.0:
                            B.pop(l, None)
                        else:
                            B[l] = v
            brows[int(e)] = B
            total += len(B)
            if total > max_entries:
                raise MemoryError(
                    f"B' materialization exceeds {max_entries} entries; "
                    "use the T-factor preamble instead")
        b_rows, b_cols, b_vals = [], [], []
        for i in range(n):
            Bi = brows.get(i)
            if Bi is None or i not in self.rows_rewritten:
                b_rows.append(i); b_cols.append(i); b_vals.append(1.0)
            else:
                for col in sorted(Bi):
                    b_rows.append(i); b_cols.append(col); b_vals.append(Bi[col])
        return from_coo(b_rows, b_cols, b_vals, self.L.shape,
                        sum_duplicates=False)
