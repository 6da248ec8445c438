"""Graph-transformation strategies.

- NoRewrite:            identity (baseline column of Table I).
- AvgLevelCost:         THE PAPER's automated naive strategy (§III).
- ManualEveryK:         the manual strategy of prior work [12]: every k-1
                        consecutive thin levels rewritten into the k-th
                        (paper: "every 9 levels is rewritten to the 10th").
- ConstrainedAvgLevelCost: beyond-paper — AvgLevelCost plus the constraints
                        the paper *proposes* in §III.A but does not implement:
                        (1) in-degree cap alpha, (2) rewrite-distance cap beta,
                        (3) coefficient-magnitude cap (numerical stability,
                        §IV observation), (4) optional dynamic avg update.

All strategies mutate an EquationStore and return per-strategy stats; the
driver in transform.py assembles the TransformedSystem and metrics.

Naming contract (documented in docs/strategies.md): every strategy class has
a STABLE `name` (used as the type identity — cache keys, CSV columns, CLI
specs) and every instance a `label` = name plus a canonical parameter suffix
(used to tell candidates of one portfolio sweep apart).  For parameter-free
strategies label == name.  See docs/strategies.md for when the portfolio
tuner (portfolio.py) prefers each strategy.

Copy of `repro.core.strategies` (numpy host half);
tests/test_torch_host_copy.py holds the two equal.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol

import numpy as np

from ..sparse.csr import CSR
from ..sparse.levels import LevelSets
from .graph import GraphView
from .rewrite import EquationStore

__all__ = [
    "Strategy", "NoRewrite", "AvgLevelCost", "ManualEveryK",
    "ConstrainedAvgLevelCost", "CriticalPathRewrite", "strategy_label",
]


def strategy_label(strategy) -> str:
    """Instance label: stable `name` + canonical parameter suffix."""
    return getattr(strategy, "label", strategy.name)


@dataclasses.dataclass
class StrategyStats:
    rows_rewritten: int = 0
    rows_skipped_constraint: int = 0
    substitutions: int = 0
    max_rewrite_distance: int = 0
    max_abs_coef: float = 0.0


class Strategy(Protocol):
    name: str

    def apply(self, store: EquationStore, view: GraphView) -> StrategyStats: ...


class NoRewrite:
    name = "no_rewriting"

    def apply(self, store: EquationStore, view: GraphView) -> StrategyStats:
        return StrategyStats()


class AvgLevelCost:
    """Paper §III, faithful.

    avgLevelCost is computed once and FIXED.  Thin levels (cost < avg) are
    walked in order; the first thin level is the initial target; rows of later
    thin levels are tentatively rewritten to the target (exact rearranged
    cost via EquationStore).  If the target's accumulated cost would exceed
    avgLevelCost, the walk re-targets: the level of the offending row becomes
    the new target (its not-yet-moved rows stay), and the walk continues.
    Emptied source levels are deleted on compaction (transform.py).
    """

    name = "avgLevelCost"

    def apply(self, store: EquationStore, view: GraphView) -> StrategyStats:
        stats = StrategyStats()
        avg = view.avg_level_cost
        thin = view.thin_levels()
        if thin.size < 2:
            return stats
        levels: LevelSets = view.levels
        target = int(thin[0])
        target_cost = float(view.level_cost[target])
        for lvl_idx in range(1, thin.size):
            lvl = int(thin[lvl_idx])
            rows = levels.rows_in_level(lvl)
            moved_any = False
            for pos, r in enumerate(rows):
                r = int(r)
                res = store.rewrite_to_level(r, target)
                c = res.paper_cost
                if target_cost + c <= avg:
                    store.commit(r, target, res)
                    target_cost += c
                    stats.rows_rewritten += 1
                    moved_any = True
                else:
                    # re-target at this level: remaining rows stay here
                    target = lvl
                    target_cost = float(
                        sum(store.row_paper_cost(int(q)) for q in rows[pos:]))
                    break
            del moved_any
        stats.substitutions = store.total_subs
        stats.max_rewrite_distance = store.max_rewrite_distance
        stats.max_abs_coef = store.max_abs_coef_seen
        return stats


class ManualEveryK:
    """Prior-work [12] manual strategy, automated the way the paper applies it:

    Among the thin levels (paper, torso2: "we picked all levels with a cost
    smaller than avgLevelCost and rewrote every 9 level of these to the
    10th"), take consecutive groups of k; the FIRST level of each group is the
    target; ALL rows of the remaining k-1 levels are rewritten into it,
    unconditionally (no cost cap — which is exactly why this strategy inflates
    torso2's total cost by ~40% in the paper's Table I).
    """

    name = "manual_every_k"

    def __init__(self, k: int = 10, max_gap: int = 1):
        self.k = k
        self.max_gap = max_gap  # paper: "levels close to each other are
        #                          prioritized to form groups"
        self.label = f"manual_every_k(k={k},gap={max_gap})"

    def apply(self, store: EquationStore, view: GraphView) -> StrategyStats:
        stats = StrategyStats()
        thin = view.thin_levels()
        if thin.size < 2:
            return stats
        levels = view.levels
        # split the thin list into runs of near-consecutive levels, then
        # group every k levels within a run
        runs: list[list[int]] = [[int(thin[0])]]
        for lvl in thin[1:]:
            if int(lvl) - runs[-1][-1] <= self.max_gap:
                runs[-1].append(int(lvl))
            else:
                runs.append([int(lvl)])
        for run in runs:
            for g in range(0, len(run), self.k):
                group = run[g:g + self.k]
                if len(group) < 2:
                    continue
                target = group[0]
                for lvl in group[1:]:
                    for r in levels.rows_in_level(lvl):
                        r = int(r)
                        res = store.rewrite_to_level(r, target)
                        store.commit(r, target, res)
                        stats.rows_rewritten += 1
        stats.substitutions = store.total_subs
        stats.max_rewrite_distance = store.max_rewrite_distance
        stats.max_abs_coef = store.max_abs_coef_seen
        return stats


class CriticalPathRewrite:
    """Beyond-paper: §III.A proposal (2) — "rewrite if row is on critical
    path".

    The DAG's depth is set by rows with depth(i) + height(i) == depth_max.
    Each round rewrites every critical row in the DEEPEST level upward by at
    most `beta` levels (subject to an in-degree cap); if afterwards the
    recomputed depth did not shrink, the round is a fixpoint and we stop.
    Unlike avgLevelCost this touches only rows that actually gate the
    synchronization count, so rows-rewritten is minimal per level removed.
    """

    name = "critical_path"

    def __init__(self, beta: int = 8, alpha: int = 32,
                 max_rounds: int = 10_000):
        self.beta, self.alpha, self.max_rounds = beta, alpha, max_rounds
        self.label = (f"critical_path(beta={beta},alpha={alpha},"
                      f"rounds={max_rounds})")

    def apply(self, store: EquationStore, view: GraphView) -> StrategyStats:
        stats = StrategyStats()
        level_of = store.level_of
        for _ in range(self.max_rounds):
            depth = int(level_of.max())
            if depth == 0:
                break
            deepest = np.flatnonzero(level_of == depth)
            target = max(0, depth - self.beta)
            moved = False
            for r in deepest:
                r = int(r)
                res = store.rewrite_to_level(r, target)
                if self.alpha is not None and res.indegree > self.alpha:
                    stats.rows_skipped_constraint += 1
                    continue
                store.commit(r, target, res)
                stats.rows_rewritten += 1
                moved = True
            if not moved:
                break
        stats.substitutions = store.total_subs
        stats.max_rewrite_distance = store.max_rewrite_distance
        stats.max_abs_coef = store.max_abs_coef_seen
        return stats


class ConstrainedAvgLevelCost:
    """Beyond-paper: AvgLevelCost + the §III.A constraints.

    alpha:      max in-degree of a rewritten row (paper: "rewrite if row's
                indegree < alpha") — also caps cost/precision growth.
    beta:       max rewrite distance in levels ("distance between indegrees"
                is a locality proxy; we use level distance, the quantity the
                paper's own limitation discussion centres on).
    coef_cap:   max |coefficient| growth factor vs the original matrix
                (numerical-stability guard, paper §IV Fig. 3 observation).
    update_avg: recompute the average as levels are deleted (ablation of the
                paper's "avgLevelCost kept fixed" choice).
    """

    name = "constrained_avg"

    def __init__(self, alpha: int | None = 8, beta: int | None = 64,
                 coef_cap: float | None = 1e6, update_avg: bool = False):
        self.alpha, self.beta, self.coef_cap = alpha, beta, coef_cap
        self.update_avg = update_avg
        cap = "none" if coef_cap is None else f"{coef_cap:g}"
        self.label = (f"constrained_avg(a={alpha},b={beta},"
                      f"c={cap},dyn={int(update_avg)})")

    def apply(self, store: EquationStore, view: GraphView) -> StrategyStats:
        stats = StrategyStats()
        base_coef = float(np.abs(view.L.data).max()) if view.L.nnz else 1.0
        avg = view.avg_level_cost
        thin = view.thin_levels()
        if thin.size < 2:
            return stats
        levels = view.levels
        total_cost = float(view.total_cost)
        n_levels = view.num_levels
        target = int(thin[0])
        target_cost = float(view.level_cost[target])
        for lvl_idx in range(1, thin.size):
            lvl = int(thin[lvl_idx])
            rows = levels.rows_in_level(lvl)
            emptied = True
            for pos, r in enumerate(rows):
                r = int(r)
                if self.beta is not None and lvl - target > self.beta:
                    stats.rows_skipped_constraint += len(rows) - pos
                    emptied = False
                    target, target_cost = lvl, float(
                        sum(store.row_paper_cost(int(q)) for q in rows[pos:]))
                    break
                res = store.rewrite_to_level(r, target)
                if self.alpha is not None and res.indegree > self.alpha:
                    stats.rows_skipped_constraint += 1
                    emptied = False
                    continue
                if (self.coef_cap is not None
                        and res.max_abs_coef > self.coef_cap * base_coef):
                    stats.rows_skipped_constraint += 1
                    emptied = False
                    continue
                c = res.paper_cost
                if target_cost + c <= avg:
                    old_c = store.row_paper_cost(r)
                    store.commit(r, target, res)
                    target_cost += c
                    total_cost += c - old_c
                    stats.rows_rewritten += 1
                else:
                    target = lvl
                    target_cost = float(
                        sum(store.row_paper_cost(int(q)) for q in rows[pos:]))
                    emptied = False
                    break
            if emptied and self.update_avg:
                n_levels -= 1
                avg = total_cost / max(n_levels, 1)
        stats.substitutions = store.total_subs
        stats.max_rewrite_distance = store.max_rewrite_distance
        stats.max_abs_coef = store.max_abs_coef_seen
        return stats
