"""tune="auto" through the port's facades against the reference's, on
the CPU: `TriangularOperator.from_csr(L)` and `Preconditioner.ic0/ilu0(A)`
at their default tune, with `device="cpu"` and the same cost-model
constants handed to both packages, pick the reference's strategy, and
their refined solves agree with the reference's to 1e-10 relative to
scale (both refine in float64 to a relative residual of 1e-10).  Also the
port's cache keys for tuned operators.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.portfolio import CostModel as RefCostModel
from repro.precond import Preconditioner as RefPreconditioner
from repro.solver import TriangularOperator as RefOperator
from repro.sparse import generators as ref_gen

from repro_torch.core.portfolio import (CostModel, StrategyPortfolio,
                                        default_cost_model_for)
from repro_torch.core.strategies import NoRewrite
from repro_torch.precond import Preconditioner
from repro_torch.solver import TriangularOperator
from repro_torch.sparse import generators

torch.set_num_threads(1)

MATRICES = {"lung2_like(0.05)": lambda g: g.lung2_like(0.05),
            "torso2_like(0.05)": lambda g: g.torso2_like(0.05)}
# the reference's default constants, as plain numbers handed to both
CONSTANTS = dataclasses.asdict(RefCostModel())
REFINED_RTOL = 1e-10


@pytest.fixture(autouse=True)
def _fresh_caches(tmp_path, monkeypatch):
    # the operator's disk tier writes under the test's own directory
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "cache"))
    for cls in (TriangularOperator, RefOperator):
        cls.clear_memory_cache()
    for cls in (Preconditioner, RefPreconditioner):
        cls.clear_pair_decisions()
    yield


def _rel(x, x_ref):
    return np.abs(x - x_ref).max() / max(1.0, np.abs(x_ref).max())


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_from_csr_auto_picks_the_reference_label(name):
    L, L_ref = MATRICES[name](generators), MATRICES[name](ref_gen)
    op = TriangularOperator.from_csr(L, device="cpu",
                                     cost_model=CostModel(**CONSTANTS))
    ref = RefOperator.from_csr(L_ref, cost_model=RefCostModel(**CONSTANTS),
                               cache=False)
    assert op.strategy == ref.strategy
    assert [c.label for c in op.report.candidates] == \
        [c.label for c in ref.report.candidates]
    b = np.random.default_rng(3).standard_normal(L.n_rows)
    x, x_ref = op.solve(b), ref.solve(b)
    assert op.stats.last_residual <= 1e-10
    assert _rel(x, x_ref) <= REFINED_RTOL


@pytest.mark.parametrize("kind", ["ic0", "ilu0"])
def test_preconditioner_auto_picks_the_reference_label(kind):
    A = generators.spd_from_lower(generators.lung2_like(0.05), seed=0)
    A_ref = ref_gen.spd_from_lower(ref_gen.lung2_like(0.05), seed=0)
    cm = CostModel(**CONSTANTS)
    P = getattr(Preconditioner, kind)(A, device="cpu", cost_model=cm)
    P_ref = getattr(RefPreconditioner, kind)(
        A_ref, cost_model=RefCostModel(**CONSTANTS), cache=False)
    assert P.strategy == P_ref.strategy
    assert P.report.best_label == P_ref.report.best_label
    assert P.report.combined == P_ref.report.combined
    r = np.random.default_rng(4).standard_normal(A.n_rows)
    assert _rel(P.apply(r, max_refine=6), P_ref.apply(r, max_refine=6)) \
        <= REFINED_RTOL
    # the decision is memoized under the system and the configuration
    again = getattr(Preconditioner, kind)(A, device="cpu", cost_model=cm)
    assert again.report is P.report


def test_auto_cache_keys_the_engine_and_the_cost_model():
    L = generators.lung2_like(0.02)
    op = TriangularOperator.from_csr(L, device="cpu")
    assert TriangularOperator.from_csr(L, device="cpu").stats.cache_source \
        == "memory"
    other = TriangularOperator.from_csr(L, device="cpu",
                                        cost_model=CostModel())
    assert other.stats.cache_source == "built"
    assert op.report.cost_model == default_cost_model_for("torch")
    assert other.report.cost_model == CostModel()
    custom = TriangularOperator.from_csr(
        L, device="cpu", portfolio=StrategyPortfolio(
            candidates=[NoRewrite()], device="cpu"))
    assert custom.strategy == "no_rewriting"
    assert custom.stats.cache_source == "built"
    # the transposed operator re-tunes its own sweep
    T = op.transposed()
    assert T.report is not None and T.transpose


def test_measured_pair_mode_times_the_top_k_and_no_rewriting():
    A = generators.spd_from_lower(generators.lung2_like(0.02), seed=0)
    model = Preconditioner.ic0(A, device="cpu")
    P = Preconditioner.ic0(A, device="cpu", measure_top_k=2)
    measured = [c for c in P.report.combined if c["measured"]]
    labels = [c["label"] for c in measured]
    top2 = [c["label"] for c in model.report.combined[:2]]
    assert set(labels) == set(top2) | {"no_rewriting"}
    assert P.report.combined[:len(measured)] == measured     # ranked first
    assert [c["total_us"] for c in measured] == \
        sorted(c["total_us"] for c in measured)
    assert P.strategy == P.report.best_label == labels[0]
    # a different decision from the model's: memoized under its own key
    assert P.report is not model.report
