"""The port's strategy-portfolio tuner against the reference's, on the CPU.

Both packages tune the same matrices (lung2_like(0.05), torso2_like(0.05)
and the IC(0)/ILU(0) factors of systems built from them, from the
generators' seeds) under the same cost-model constants, the port through
its plain "torch" engine, whose counts are the reference's schedule
counts.  The port's preamble-step and launch terms are zero there, so the
two must rank alike: the same labels in the same order, the same counts,
predicted microseconds equal to 1e-12 relative (both sum the same float
terms, plus exact zeros on the port's side), the same failed candidates
and the same pair decision (tests/test_torch_autotune.py holds the
facades that consume them).

The port's own parts: the CUDA engine's counts (the kernel's packed steps,
checked on the CPU against `pack_groups`), measured mode (re-ranking
within the top k, timeouts, host-side failures), and the port's default
constants, which are not the reference's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.portfolio import CostModel as RefCostModel
from repro.core.portfolio import StrategyPortfolio as RefPortfolio
from repro.precond import factorize as ref_factorize
from repro.solver.operator import orient_lower as ref_orient_lower
from repro.sparse import generators as ref_gen

from repro_torch.core.portfolio import (CostModel, StrategyPortfolio,
                                        default_candidates,
                                        default_cost_model_for)
from repro_torch.core.strategies import AvgLevelCost, NoRewrite
from repro_torch.kernels import sptrsv_level as K
from repro_torch.precond import factorize
from repro_torch.solver.operator import orient_lower
from repro_torch.solver.schedule import schedule_for_preamble
from repro_torch.sparse import generators

torch.set_num_threads(1)

MATRICES = {"lung2_like(0.05)": lambda g: g.lung2_like(0.05),
            "torso2_like(0.05)": lambda g: g.torso2_like(0.05)}
REF_FIELDS = ("step_overhead_us", "us_per_padded_flop", "us_per_byte",
              "us_per_preamble_nnz", "collective_latency_us")
# the reference's two presets, as plain numbers handed to both packages
CONSTANTS = {
    "reference_default": dataclasses.asdict(RefCostModel()),
    "reference_cpu": dataclasses.asdict(RefCostModel.cpu()),
}


class Exploding:
    """A strategy whose rewrite raises on the host, in either package."""

    name = "exploding"
    label = "exploding(boom=1)"

    def apply(self, store, view):
        raise RuntimeError("boom")


def _models(key):
    c = CONSTANTS[key]
    return CostModel(**c), RefCostModel(**c)


def _assert_same_ranking(rep, ref):
    assert [c.label for c in rep.candidates] == \
        [c.label for c in ref.candidates]
    for c, r in zip(rep.candidates, ref.candidates):
        assert (c.steps, c.num_levels, c.padded_flops, c.memory_bytes,
                c.nnz_T) == (r.steps, r.num_levels, r.padded_flops,
                             r.memory_bytes, r.nnz_T), c.label
        assert (c.error is None) == (r.error is None), c.label
        if c.error is None:
            assert c.predicted_us == pytest.approx(r.predicted_us,
                                                   rel=1e-12, abs=0)
            for k, v in r.breakdown.items():
                assert c.breakdown[k] == pytest.approx(v, rel=1e-12, abs=0)
            assert c.breakdown["launches_us"] == 0.0
        else:
            assert c.error == r.error
    assert rep.matrix == ref.matrix


@pytest.mark.parametrize("name,constants", [
    ("lung2_like(0.05)", "reference_default"),
    ("torso2_like(0.05)", "reference_cpu")])
def test_tune_ranks_as_the_reference(name, constants):
    cm, ref_cm = _models(constants)
    cands = default_candidates() + [Exploding()]
    from repro.core.portfolio import default_candidates as ref_candidates
    rep = StrategyPortfolio(candidates=cands, cost_model=cm, engine="torch",
                            device="cpu").tune(MATRICES[name](generators))
    ref = RefPortfolio(candidates=ref_candidates() + [Exploding()],
                       cost_model=ref_cm).tune(MATRICES[name](ref_gen))
    _assert_same_ranking(rep, ref)
    assert [c.label for c in rep.candidates if c.error] == \
        ["exploding(boom=1)"]


@pytest.mark.parametrize("kind", ["ic0", "ilu0"])
def test_tune_pair_decides_as_the_reference(kind):
    cm, ref_cm = _models("reference_default")
    A = generators.spd_from_lower(generators.lung2_like(0.05), seed=0)
    A_ref = ref_gen.spd_from_lower(ref_gen.lung2_like(0.05), seed=0)
    fac = getattr(factorize, kind)(A)
    fac_ref = getattr(ref_factorize, kind)(A_ref)
    if kind == "ic0":
        sides = ((fac.L, "lower", False), (fac.L, "lower", True))
        ref_sides = ((fac_ref.L, "lower", False), (fac_ref.L, "lower", True))
    else:
        sides = ((fac.L, "lower", False), (fac.U, "upper", False))
        ref_sides = ((fac_ref.L, "lower", False),
                     (fac_ref.U, "upper", False))
    pair = StrategyPortfolio(cost_model=cm, engine="torch",
                             device="cpu").tune_pair(
        *(orient_lower(*s)[0] for s in sides))
    ref = RefPortfolio(cost_model=ref_cm).tune_pair(
        *(ref_orient_lower(*s)[0] for s in ref_sides))
    assert pair.best_label == ref.best_label
    assert pair.combined == ref.combined
    _assert_same_ranking(pair.fwd, ref.fwd)
    _assert_same_ranking(pair.bwd, ref.bwd)


def _synthetic(profile_cls, engine="stepwise", constant_bytes=True):
    rng = np.random.default_rng(0)
    flops = rng.integers(1000, 5000, size=12).astype(np.int64)
    bytes_ = (np.full(12, 4096.0) if constant_bytes
              else rng.uniform(1e3, 1e4, size=12))
    t_us = 3.0 + 2e-3 * flops + 1e-4 * bytes_
    return profile_cls(
        engine=engine, num_steps=12, reps=1, step_ms=t_us / 1e3,
        collective_ms=None, step_padded_flops=flops, step_real_flops=flops,
        step_bytes=bytes_, width_buckets=[])


@pytest.mark.parametrize("constant_bytes", [True, False],
                         ids=["degenerate", "full_rank"])
def test_calibrate_fits_as_the_reference(constant_bytes):
    from repro.obs.profile import ScheduleProfile as RefProfile
    from repro_torch.obs.profile import ScheduleProfile
    base = dict(CONSTANTS["reference_default"], us_per_byte=1e-4)
    got = CostModel(**base).calibrate(
        _synthetic(ScheduleProfile, constant_bytes=constant_bytes))
    want = RefCostModel(**base).calibrate(
        _synthetic(RefProfile, constant_bytes=constant_bytes))
    for f in REF_FIELDS:
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-12,
                                                abs=1e-15), f
    # the port's terms: on the plain engine a preamble step costs the
    # mean fitted step; no launch charge without a measured launch
    prof = _synthetic(ScheduleProfile, constant_bytes=constant_bytes)
    mean_step = np.mean(got.step_overhead_us
                        + got.us_per_padded_flop * prof.step_padded_flops
                        + got.us_per_byte * prof.step_bytes)
    assert got.us_per_preamble_step == pytest.approx(mean_step, rel=1e-12)
    assert got.us_per_launch == 0.0


def test_calibrate_on_a_card_profile_sets_the_port_terms():
    from repro_torch.obs.profile import ScheduleProfile
    prof = dataclasses.replace(
        _synthetic(ScheduleProfile, engine="cuda", constant_bytes=False),
        launch_us=7.5)
    cm = CostModel(step_overhead_us=0.0, us_per_padded_flop=0.0,
                   us_per_byte=0.0).calibrate(prof)
    assert cm.step_overhead_us == pytest.approx(3.0, rel=1e-9)
    assert cm.us_per_padded_flop == pytest.approx(2e-3, rel=1e-9)
    assert cm.us_per_byte == pytest.approx(1e-4, rel=1e-9)
    assert cm.us_per_preamble_step == cm.step_overhead_us
    assert cm.us_per_launch == 7.5


def test_port_default_constants_are_not_the_reference():
    ref_presets = [dataclasses.asdict(RefCostModel()),
                   dataclasses.asdict(RefCostModel.cpu()),
                   dataclasses.asdict(RefCostModel.sharded())]
    for cm in (CostModel(), default_cost_model_for("cuda"),
               default_cost_model_for("torch")):
        mine = {f: getattr(cm, f) for f in REF_FIELDS}
        for ref in ref_presets:
            assert mine != {f: ref[f] for f in REF_FIELDS}
    assert CostModel().us_per_preamble_step == 0.0
    assert CostModel().us_per_launch == 0.0
    assert default_cost_model_for("cuda").us_per_launch > 0
    assert StrategyPortfolio(device="cpu").cost_model == \
        default_cost_model_for("torch")


def _float32_dag_columns(A):
    """Rows and deps of each level of the DAG of a lower-triangular A,
    row by row, with the entries that are 0 in float32 dropped."""
    level = np.zeros(A.n_rows, dtype=np.int64)
    deps = np.zeros(A.n_rows, dtype=np.int64)
    for i in range(A.n_rows):
        lo, hi = A.indptr[i], A.indptr[i + 1]
        cols = A.indices[lo:hi]
        keep = (cols < i) & (A.data[lo:hi].astype(np.float32) != 0)
        assert (cols <= i).all()
        deps[i] = keep.sum()
        level[i] = 1 + level[cols[keep]].max() if deps[i] else 0
    return (np.bincount(level),
            np.bincount(level, weights=deps).astype(np.int64))


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_cuda_counts_are_the_packed_steps(name):
    rep = StrategyPortfolio(engine="cuda", device="cpu").tune(
        MATRICES[name](generators))
    for c in rep.candidates:
        main = K.pack_schedule(c.sched)
        psched, _, _ = schedule_for_preamble(c.ts)
        packs = [main] + ([K.pack_schedule(psched)] if psched is not None
                          else [])
        assert c.steps == main.num_steps, c.label
        assert c.preamble_steps == (packs[1].num_steps if psched is not None
                                    else 0), c.label
        assert c.launches == sum(p.launches for p in packs), c.label
        # the tile kernel's rows and deps: the free pass's are a launch
        rows = np.concatenate([p.step_rows[1:] for p in packs])
        deps = np.concatenate([p.step_deps[1:] for p in packs])
        assert c.padded_flops == K.step_flops(rows, deps).sum()
        assert c.memory_bytes == K.step_bytes(rows, deps).sum()
        rows, deps = _float32_dag_columns(c.ts.A)
        np.testing.assert_array_equal(rows, main.step_rows)
        np.testing.assert_array_equal(deps, main.step_deps)


def test_cuda_counts_drop_coefficients_that_underflow_in_float32():
    # lung2's avgLevelCost system holds values below 1e-45: 0 in a
    # float32 schedule, so no dependency for the kernel
    L = generators.lung2_like(0.05)
    from repro_torch.core.transform import transform
    from repro_torch.solver.schedule import schedule_for_transformed
    ts = transform(L, AvgLevelCost(), validate=False, codegen=False)
    from repro_torch.solver.engines import get_engine
    shape = get_engine("cuda").sweep_shape(ts, schedule_for_transformed(ts))
    assert shape["steps"] == K.pack_schedule(
        schedule_for_transformed(ts)).num_steps
    assert shape["steps"] < ts.metrics.num_levels_after


def test_measured_mode_reranks_only_within_top_k():
    L = generators.lung2_like(0.05)
    model = StrategyPortfolio(device="cpu").tune(L)
    meas = StrategyPortfolio(measure_top_k=3, device="cpu").tune(L)
    top = [c.label for c in model.candidates[:3]]
    assert sorted(c.label for c in meas.candidates[:3]) == sorted(top)
    times = [c.measured_us for c in meas.candidates[:3]]
    assert all(t is not None and t > 0 for t in times)
    assert times == sorted(times)
    assert [c.label for c in meas.candidates[3:]] == \
        [c.label for c in model.candidates[3:]]
    assert all(c.measured_us is None for c in meas.candidates[3:])


def test_measured_mode_notes_a_timeout():
    rep = StrategyPortfolio(candidates=[NoRewrite(), AvgLevelCost()],
                            measure_top_k=2, measure_iters=3,
                            measure_timeout_s=0.0,
                            device="cpu").tune(generators.lung2_like(0.02))
    for c in rep.candidates:
        assert c.measure_note.startswith("timeout: 1/3 reps")
        assert c.measured_us > 0


def test_host_side_candidate_failure_does_not_stop_the_run():
    rep = StrategyPortfolio(candidates=[Exploding(), NoRewrite(),
                                        AvgLevelCost()], measure_top_k=2,
                            device="cpu").tune(generators.lung2_like(0.02))
    failed = [c for c in rep.candidates if c.error is not None]
    assert [c.label for c in failed] == ["exploding(boom=1)"]
    assert failed[0].error == "RuntimeError: boom"
    assert rep.candidates[-1] is failed[0]
    assert all(c.measured_us is not None for c in rep.candidates[:2])


def test_every_candidate_failing_raises():
    with pytest.raises(RuntimeError, match="every portfolio candidate"):
        StrategyPortfolio(candidates=[Exploding()], device="cpu").tune(
            generators.lung2_like(0.02))


def test_each_tune_transforms_every_candidate_once(monkeypatch):
    # a tune keeps nothing for the next one: re-tuning under another cost
    # model transforms every candidate again and counts the same shapes
    import repro_torch.core.portfolio as P
    calls = []
    real = P.transform
    monkeypatch.setattr(P, "transform",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    L = generators.lung2_like(0.02)
    first = StrategyPortfolio(device="cpu").tune(L)
    assert len(calls) == len(default_candidates())
    again = StrategyPortfolio(cost_model=CostModel(), device="cpu").tune(L)
    assert len(calls) == 2 * len(default_candidates())
    shape = {c.label: (c.steps, c.padded_flops, c.memory_bytes, c.nnz_T)
             for c in first.candidates}
    assert {c.label: (c.steps, c.padded_flops, c.memory_bytes, c.nnz_T)
            for c in again.candidates} == shape
