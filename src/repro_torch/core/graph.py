"""Dependency-graph view + the paper's cost model (§III).

cost(row)  = 2*nnz(row) - 1          (nnz includes the diagonal)
           = 2*|strict-lower deps| + 1
cost(level)= sum of row costs = 2*sum(nnz) - n_rows_in_level
avgLevelCost = totalCost / numLevels   (FIXED during transformation)

The paper's cost model treats the right-hand-side combination of a rewritten
row (our B' entries) as *free* — its prototype bakes b into generated code.
We additionally track `operator_cost`, which charges 2*|B'| - 1 for rows whose
B' is not the trivial identity row, i.e. the honest any-b solve cost.  The
B'-combination is dependency-free (a pure SpMV preamble), so the paper cost is
exactly the cost of the *dependency-constrained* part of the solve.

Copy of `repro.core.graph` (numpy host half);
tests/test_torch_host_copy.py holds the two equal.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..sparse.csr import CSR
from ..sparse.levels import LevelSets, build_levels

__all__ = ["CostModel", "GraphView"]


PAPER_ROW_COST = lambda n_deps: 2 * n_deps + 1  # noqa: E731


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Paper cost model; see module docstring."""

    @staticmethod
    def row_cost(n_deps: int) -> int:
        return 2 * n_deps + 1

    @staticmethod
    def operator_row_cost(n_deps: int, n_b: int, trivial_b: bool) -> int:
        base = 2 * n_deps + 1
        return base if trivial_b else base + 2 * n_b - 1


class GraphView:
    """Levels + costs of a lower-triangular CSR matrix (read-only snapshot)."""

    def __init__(self, L: CSR, levels: LevelSets | None = None):
        self.L = L
        self.levels = levels if levels is not None else build_levels(L)
        deps = L.row_nnz() - 1  # strict-lower count (diagonal always present)
        self.row_cost = (2 * deps + 1).astype(np.int64)
        self.level_cost = np.zeros(self.levels.num_levels, dtype=np.int64)
        np.add.at(self.level_cost, self.levels.level_of, self.row_cost)

    @property
    def num_levels(self) -> int:
        return self.levels.num_levels

    @property
    def total_cost(self) -> int:
        return int(self.level_cost.sum())

    @property
    def avg_level_cost(self) -> float:
        return self.total_cost / max(self.num_levels, 1)

    def thin_levels(self) -> np.ndarray:
        """Levels with cost < avgLevelCost (paper's thin-level criterion)."""
        return np.flatnonzero(self.level_cost < self.avg_level_cost)
