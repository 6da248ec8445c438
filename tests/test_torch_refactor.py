"""The port's value-update fast path against the reference's, on the CPU.

Both packages take the same matrices (`lung2_like(0.05)`,
`torso2_like(0.05)`) and the same revalued copies, made from a seed on
the frozen pattern, and:

* `replay_transform` gives `array_equal` transformed systems for the four
  paper strategies, and the same `PatternMismatchError` on drift;
* `repack_schedule_values` gives schedules equal to the reference's and to
  a fresh build on the new values;
* `update_values(device="cpu")` solves within 1e-12 (relative to scale)
  of the reference's `update_values` in all four sweeps, batched too:
  both are refined in float64 to a residual <= 1e-10, and land within a
  few ulps of each other;
* the pattern tier of `from_csr` answers "pattern" from memory and from
  disk, as in the reference's tests/test_refactor.py;
* `Preconditioner.refactor(device="cpu")` gives the reference's M^-1 within
  tests/test_torch_precond.py's APPLY_RTOL.

The SpTRSV kernel's value refresh and the zero trap are held in
tests/test_torch_relevel.py, beside the packing they refresh.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.portfolio import make_strategy as ref_make_strategy
from repro.core.resilience import PatternMismatchError as RefMismatch
from repro.core.transform import replay_transform as ref_replay
from repro.core.transform import transform as ref_transform
from repro.precond import Preconditioner as RefPreconditioner
from repro.solver import TriangularOperator as RefOperator
from repro.solver import schedule as ref_schedule
from repro.sparse import generators as ref_gen

from repro_torch.core.portfolio import make_strategy
from repro_torch.core.resilience import PatternMismatchError
from repro_torch.core.transform import replay_transform, transform
from repro_torch.precond import Preconditioner
from repro_torch.solver import TriangularOperator
from repro_torch.solver.schedule import (repack_schedule_values,
                                         schedule_for_preamble,
                                         schedule_for_transformed)
from repro_torch.sparse import generators

torch.set_num_threads(1)

MATRICES = {"lung2_like(0.05)": lambda g: g.lung2_like(0.05),
            "torso2_like(0.05)": lambda g: g.torso2_like(0.05)}
PAPER_STRATEGIES = ["no_rewriting", "avgLevelCost", "manual_every_k",
                    "constrained_avg"]
SWEEPS = [("lower", False), ("lower", True), ("upper", False),
          ("upper", True)]
UPDATE_RTOL = 1e-12
APPLY_RTOL = 5e-5           # tests/test_torch_precond.py's M^-1 parity


@pytest.fixture(autouse=True)
def _fresh_caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "port"))
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "ref"))
    for cls in (TriangularOperator, RefOperator):
        cls.clear_memory_cache()
    yield
    for cls in (TriangularOperator, RefOperator):
        cls.clear_memory_cache()


def _revalued(M, seed=1, diag_scale=1.6):
    """Same pattern, perturbed values, scaled diagonal (tests/
    test_refactor.py's recipe); works on either package's CSR."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(M.n_rows), M.row_nnz())
    d_mask = M.indices == rows
    data = M.data * (1.0 + 0.25 * rng.standard_normal(M.nnz))
    data[d_mask] = M.data[d_mask] * diag_scale
    return M.with_data(data)


def _pair(name, side="lower"):
    pair = (MATRICES[name](generators), MATRICES[name](ref_gen))
    return pair if side == "lower" else tuple(m.transpose() for m in pair)


def _rel(x, x_ref):
    return np.abs(x - x_ref).max() / max(1.0, np.abs(x_ref).max())


def _assert_csr_equal(a, b):
    assert a.shape == b.shape
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)


def _assert_ts_equal(ts, ts_ref):
    _assert_csr_equal(ts.A, ts_ref.A)
    _assert_csr_equal(ts.T, ts_ref.T)
    for name in ("src", "diag", "level_of_assigned", "level_of_recomputed"):
        np.testing.assert_array_equal(getattr(ts, name),
                                      getattr(ts_ref, name), err_msg=name)


def _assert_sched_equal(a, b):
    assert a.num_steps == b.num_steps and a.n_carry == b.n_carry
    for ga, gb in zip(a.groups, b.groups, strict=True):
        for name in ("row_ids", "dep_idx", "dep_coef", "dinv", "carry_in",
                     "carry_out"):
            x, y = getattr(ga, name), getattr(gb, name)
            if y is None:
                assert x is None, name
                continue
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)


# -- host layers: replay_transform, repack_schedule_values --------------------

@pytest.mark.parametrize("strategy", PAPER_STRATEGIES)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_replay_transform_matches_reference(name, strategy):
    L, L_ref = _pair(name)
    ts = transform(L, make_strategy(strategy), validate=False)
    ts_ref = ref_transform(L_ref, ref_make_strategy(strategy),
                           validate=False, codegen=False)
    r = replay_transform(_revalued(L, seed=3), ts)
    r_ref = ref_replay(_revalued(L_ref, seed=3), ts_ref)
    _assert_ts_equal(r, r_ref)
    assert dataclasses.asdict(r.metrics) == dataclasses.asdict(r_ref.metrics)
    assert r.plan is ts.plan


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_replay_transform_raises_on_drift_like_reference(name):
    L, L_ref = _pair(name)
    ts = transform(L, make_strategy("avgLevelCost"), validate=False)
    ts_ref = ref_transform(L_ref, ref_make_strategy("avgLevelCost"),
                           validate=False, codegen=False)
    # another lower-triangular pattern of the same size: its A' differs
    other = generators.random_lower(L.n_rows, avg_offdiag=2.0, seed=11)
    other_ref = ref_gen.random_lower(L.n_rows, avg_offdiag=2.0, seed=11)
    small = generators.chain(8)
    small_ref = ref_gen.chain(8)
    for M, M_ref in ((other, other_ref), (small, small_ref)):
        with pytest.raises(PatternMismatchError) as got:
            replay_transform(M, ts, where="here")
        with pytest.raises(RefMismatch) as want:
            ref_replay(M_ref, ts_ref, where="here")
        assert str(got.value) == str(want.value)
        assert got.value.detail == want.value.detail


@pytest.mark.parametrize("strategy", ["no_rewriting", "avgLevelCost"])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_repack_schedule_values_matches_reference_and_fresh(name, strategy):
    L, L_ref = _pair(name)
    kw = dict(chunk=32, max_deps=4)
    ts = transform(L, make_strategy(strategy), validate=False)
    ts_ref = ref_transform(L_ref, ref_make_strategy(strategy),
                           validate=False, codegen=False)
    r = replay_transform(_revalued(L, seed=5), ts)
    r_ref = ref_replay(_revalued(L_ref, seed=5), ts_ref)
    sched = schedule_for_transformed(ts, **kw)
    new = repack_schedule_values(sched, r.A.data, r.diag)
    new_ref = ref_schedule.repack_schedule_values(
        ref_schedule.schedule_for_transformed(ts_ref, **kw), r_ref.A.data,
        r_ref.diag)
    _assert_sched_equal(new, new_ref)
    _assert_sched_equal(new, schedule_for_transformed(r, **kw))
    assert new.groups[0].row_ids is sched.groups[0].row_ids  # shared layout
    assert new.groups[0].dep_coef is not sched.groups[0].dep_coef
    psched, _, _ = schedule_for_preamble(ts, **kw)
    if psched is not None:
        pnew = repack_schedule_values(psched, r.T.data,
                                      np.ones(r.T.n_rows))
        _assert_sched_equal(pnew, schedule_for_preamble(r, **kw)[0])
    with pytest.raises(ValueError, match="expected"):
        repack_schedule_values(sched, r.A.data[:-1], r.diag)


# -- the operator: update_values, the pattern tier, refactor ------------------

@pytest.mark.parametrize("side,transpose", SWEEPS)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_update_values_matches_reference(name, side, transpose, tmp_path):
    M, M_ref = _pair(name, side)
    kw = dict(side=side, transpose=transpose, chunk=64, max_deps=8)
    op = TriangularOperator.from_csr(M, "avgLevelCost", device="cpu",
                                     cache=False, **kw)
    ref = RefOperator.from_csr(M_ref, "avgLevelCost", cache=False, **kw)
    rng = np.random.default_rng(9)
    b = rng.standard_normal(M.n_rows)
    op.solve(b)                         # stage and compile before the update
    assert op.update_values(_revalued(M, seed=4)) is op
    ref.update_values(_revalued(M_ref, seed=4))
    assert op.stats.value_updates == 1
    assert op.stats.cache_source == "pattern" and op.stats.repacks == 0
    for rhs in (b, rng.standard_normal((M.n_rows, 4))):
        x = op.solve(rhs)
        assert op.stats.last_residual <= 1e-10
        assert _rel(x, ref.solve(rhs)) <= UPDATE_RTOL
    # the same values built from scratch solve identically
    fresh = TriangularOperator.from_csr(_revalued(M, seed=4), "avgLevelCost",
                                        device="cpu", cache=False, **kw)
    np.testing.assert_array_equal(op.solve(b), fresh.solve(b))


def test_update_values_rejects_another_pattern_and_bad_values():
    from repro_torch.core.resilience import NumericalHealthError
    L = generators.lung2_like(0.05)
    op = TriangularOperator.from_csr(L, "avgLevelCost", device="cpu",
                                     cache=False)
    with pytest.raises(PatternMismatchError, match="shape"):
        op.update_values(generators.chain(8))
    other = generators.random_lower(L.n_rows, avg_offdiag=2.0, seed=2)
    with pytest.raises(PatternMismatchError, match="update_values"):
        op.update_values(other)
    bad = L.with_data(np.where(np.arange(L.nnz) == 3, np.nan, L.data))
    with pytest.raises(NumericalHealthError):
        op.update_values(bad)
    assert op.stats.value_updates == 0


def test_pattern_tier_from_memory_and_from_disk(tmp_path):
    """tests/test_refactor.py:277-345 on the port: equal pattern, other
    values -> "pattern", bitwise equal to a fresh build; the derived
    payload is stored under its own key; the disk glob finds a base once
    the memory cache is gone; update_values stores under the new value
    key and a repeat of the same values is a memory hit."""
    L = generators.lung2_like(0.05)
    L2 = _revalued(L, seed=7)
    kw = dict(device="cpu", cache_dir=tmp_path)
    rhs = np.random.default_rng(42).standard_normal(L.n_rows)
    op = TriangularOperator.from_csr(L, "avgLevelCost", **kw)
    assert op.stats.cache_source == "built"
    op2 = TriangularOperator.from_csr(L2, "avgLevelCost", **kw)
    assert op2.stats.cache_source == "pattern"
    fresh = TriangularOperator.from_csr(L2, "avgLevelCost", device="cpu",
                                        cache=False)
    np.testing.assert_array_equal(op2.solve(rhs), fresh.solve(rhs))
    op3 = TriangularOperator.from_csr(L2, "avgLevelCost", **kw)
    assert op3.stats.cache_source == "memory"

    TriangularOperator.clear_memory_cache()
    op4 = TriangularOperator.from_csr(_revalued(L, seed=13), "avgLevelCost",
                                      **kw)
    assert op4.stats.cache_source == "pattern"
    pkey = TriangularOperator._pattern_cache_key(L, op._config)
    assert len(list(tmp_path.glob(f"torch-op-{pkey}-*.pkl"))) == 3

    op.update_values(_revalued(L, seed=21))
    assert op.stats.cache_source == "pattern"
    assert len(list(tmp_path.glob(f"torch-op-{pkey}-*.pkl"))) == 4
    L5 = _revalued(L, seed=21)
    op.update_values(L5.with_data(L5.data.copy()))
    assert op.stats.cache_source == "memory"


@pytest.mark.parametrize("kind", ["ic0", "ilu0"])
def test_preconditioner_refactor_matches_reference(kind, tmp_path):
    L, L_ref = _pair("lung2_like(0.05)")
    A = generators.spd_from_lower(L, seed=0)
    A_ref = ref_gen.spd_from_lower(L_ref, seed=0)
    # the same symmetric perturbation of both (ic0 needs SPD)
    rows = np.repeat(np.arange(A.n_rows), A.row_nnz())
    key = np.minimum(rows, A.indices) * A.n_cols + np.maximum(rows,
                                                               A.indices)
    scale = 1.0 + 0.1 * np.sin(key * 12.9898)
    scale[A.indices == rows] = 2.0
    A2, A2_ref = A.with_data(A.data * scale), A_ref.with_data(A_ref.data *
                                                              scale)
    P = getattr(Preconditioner, kind)(A, tune="avgLevelCost", device="cpu")
    P_ref = getattr(RefPreconditioner, kind)(A_ref, "avgLevelCost",
                                             cache_dir=tmp_path)
    r = np.random.default_rng(5).standard_normal(A.n_rows)
    z_before = P.apply(r)
    zd_before = P.device_apply()(torch.as_tensor(r, dtype=torch.float32))
    assert P.refactor(A2) is P
    P_ref.refactor(A2_ref)
    assert P.forward.stats.value_updates == P.backward.stats.value_updates \
        == 1
    z = P.apply(r)
    assert _rel(z, P_ref.apply(r)) < APPLY_RTOL
    assert _rel(z, z_before) > 1e-3
    zd = P.device_apply()(torch.as_tensor(r, dtype=torch.float32))
    assert _rel(zd.numpy(), z) < APPLY_RTOL
    assert not torch.equal(zd, zd_before)
    fresh = getattr(Preconditioner, kind)(A2, tune="avgLevelCost",
                                          device="cpu", cache=False)
    np.testing.assert_array_equal(z, fresh.apply(r))
    with pytest.raises(PatternMismatchError):
        P.refactor(generators.poisson2d_spd(6, 5))


def test_replay_is_bitwise_a_fresh_transform_on_pattern_only_strategies():
    """For strategies whose decisions depend on the pattern alone, replay
    equals a fresh transform of the new values (the reference's claim)."""
    L = generators.lung2_like(0.05)
    L2 = _revalued(L, seed=12)
    for strategy in ("no_rewriting", "avgLevelCost", "manual_every_k"):
        ts = transform(L, make_strategy(strategy), validate=False)
        _assert_ts_equal(replay_transform(L2, ts),
                         transform(L2, make_strategy(strategy),
                                   validate=False))


def test_orientations_share_one_pattern_key():
    """update_values on a transposed operator stores its payload under the
    key from_csr gives the new matrix in that orientation."""
    L = generators.lung2_like(0.05)
    op = TriangularOperator.from_csr(L, "no_rewriting", device="cpu",
                                     transpose=True)
    op.update_values(_revalued(L, seed=2))
    again = TriangularOperator.from_csr(_revalued(L, seed=2), "no_rewriting",
                                        device="cpu", transpose=True)
    assert again.stats.cache_source == "memory"
