"""The port's per-step profiler against the reference's, on the CPU, and
K1's stamped form.

On the CPU the port profiles the plain engine one step at a time, as the
reference does: for the same schedule (the host copies compile equal
schedules, tests/test_torch_host_copy.py) the step columns (padded and
real FLOPs, bytes) and width buckets must be equal, array for array, and
the solution both loops produce agrees to 1e-6 relative to scale (both
run in float32, summing a row's terms in another order).  K1's stamped
form gives the plain version's x on the CPU and stamps only on the card;
the tests marked `cuda` hold its x equal to the serving kernel's, bit for
bit, and its stamps against its launch's event time.
"""
import json
import time

import numpy as np
import pytest
import torch

from repro_torch.core.strategies import AvgLevelCost, NoRewrite
from repro_torch.core.transform import transform
from repro_torch.kernels import ref
from repro_torch.kernels import sptrsv_level as K
from repro_torch.obs import calibrate as calibrate_mod
from repro_torch.obs.profile import (DEFAULT_MS_BUCKETS, ScheduleProfile,
                                     _profile_and_solve, merge_profiles,
                                     profile_operator, profile_schedule)
from repro_torch.solver import TriangularOperator
from repro_torch.solver.levelset import pad_rhs, to_device
from repro_torch.solver.schedule import schedule_for_transformed
from repro_torch.sparse import generators

torch.set_num_threads(1)

ATOL = 1e-6
CASES = {
    "lung2_like(0.05)/no_rewriting":
        (lambda g: g.lung2_like(0.05), "NoRewrite"),
    "lung2_like(0.05)/avgLevelCost":
        (lambda g: g.lung2_like(0.05), "AvgLevelCost"),
    "torso2_like(0.05)/no_rewriting":
        (lambda g: g.torso2_like(0.05), "NoRewrite"),
}
PORT_STRATEGIES = {"NoRewrite": NoRewrite, "AvgLevelCost": AvgLevelCost}


def _schedules(name, chunk=256, max_deps=16):
    """The port's schedule of a case and its preamble-applied c."""
    mat, strat = CASES[name]
    ts = transform(mat(generators), PORT_STRATEGIES[strat](), validate=False,
                   codegen=False)
    b = np.random.default_rng(5).standard_normal(ts.A.n_rows)
    return (schedule_for_transformed(ts, chunk=chunk, max_deps=max_deps),
            ts.preamble(b))


def _reference_schedule(name, chunk=256, max_deps=16):
    """The reference's schedule of a case (imports JAX's package, so the
    card's tests, which run without it, never call this)."""
    import repro.core.strategies as ref_strategies
    from repro.core.transform import transform as ref_transform
    from repro.solver.schedule import schedule_for_transformed as ref_sched
    from repro.sparse import generators as ref_gen
    mat, strat = CASES[name]
    ts = ref_transform(mat(ref_gen), getattr(ref_strategies, strat)(),
                       validate=False, codegen=False)
    return ref_sched(ts, chunk=chunk, max_deps=max_deps)


@pytest.mark.parametrize("name", sorted(CASES))
def test_profile_columns_and_solution_match_the_reference(name):
    from repro.obs.profile import _profile_and_solve as ref_profile_and_solve
    sched, c = _schedules(name)
    sched_ref = _reference_schedule(name)
    prof, x = _profile_and_solve(sched, c, reps=1, warmup=0,
                                 clock=time.perf_counter, device="cpu",
                                 engine="torch")
    want, x_ref = ref_profile_and_solve(sched_ref, c, reps=1, warmup=0,
                                        clock=time.perf_counter, mesh=None,
                                        axis="model")
    assert prof.engine == want.engine == "stepwise"
    assert prof.num_steps == want.num_steps == sched.num_steps
    for col in ("step_padded_flops", "step_real_flops", "step_bytes"):
        np.testing.assert_array_equal(getattr(prof, col), getattr(want, col))
    assert prof.width_buckets == want.width_buckets
    assert prof.collective_ms is None and prof.launch_us is None
    x_ref = np.asarray(x_ref, dtype=np.float64)
    assert np.abs(x.numpy() - x_ref).max() <= \
        ATOL * max(1.0, np.abs(x_ref).max())


def test_profile_is_consistent():
    sched, c = _schedules("lung2_like(0.05)/avgLevelCost", chunk=64,
                          max_deps=8)
    prof = profile_schedule(sched, c, reps=2, warmup=1, device="cpu")
    assert len(prof.step_ms) == sched.num_steps
    assert (prof.step_ms >= 0).all() and prof.total_ms() > 0
    assert prof.total_ms() == pytest.approx(float(prof.step_ms.sum()))
    assert 0 < prof.critical_path_share() <= 1.0
    assert 0 < prof.utilization() <= 1.0
    assert int(prof.step_padded_flops.sum()) == sched.padded_flops()
    assert int(prof.step_real_flops.sum()) == sched.flops()
    hist = prof.step_histogram()
    assert sum(hist["counts"]) == sched.num_steps
    assert hist["bounds"] == list(DEFAULT_MS_BUCKETS)
    d = prof.to_dict()
    json.dumps(d)
    assert d["slowest_steps"] == prof.slowest_steps()


def test_profile_operator_routes_orientation():
    L = generators.lung2_like(0.02)
    op = TriangularOperator.from_csr(L, "no_rewriting", transpose=True,
                                     device="cpu", cache=False)
    prof = profile_operator(op, reps=1, warmup=0)
    assert prof.num_steps == op.schedule.num_steps
    assert prof.engine == "stepwise"


def test_merge_profiles_concatenates_the_steps():
    def prof(k, launch):
        return ScheduleProfile(
            engine="cuda", num_steps=k, reps=1, step_ms=np.ones(k),
            collective_ms=None, step_padded_flops=np.arange(k),
            step_real_flops=np.arange(k), step_bytes=np.full(k, 8.0),
            width_buckets=[{"width": k}], launch_us=launch)

    m = merge_profiles([prof(3, 4.0), prof(2, 6.0), prof(4, None)])
    assert m.num_steps == 9 and m.engine == "cuda"
    np.testing.assert_array_equal(m.step_padded_flops,
                                  [0, 1, 2, 0, 1, 0, 1, 2, 3])
    assert m.launch_us == 5.0
    assert len(m.width_buckets) == 3
    with pytest.raises(ValueError):
        merge_profiles([])


def test_stamped_form_on_the_cpu_is_the_plain_version():
    sched, c = _schedules("torso2_like(0.05)/no_rewriting")
    ds = to_device(sched, "cpu")
    c_pad = pad_rhs(torch.as_tensor(c, dtype=torch.float32))
    before = dict(K.LAUNCHES)
    run = K.sptrsv_groups_stamped(ds.groups, c_pad, n=sched.n,
                                  n_carry=sched.n_carry)
    assert K.LAUNCHES == dict(before, plain=before["plain"] + 1)
    assert run.stamps is None and run.event_ms() == (0.0, 0.0)
    want = ref.sptrsv_levels_grouped_ref(ds.groups, c_pad, sched.n,
                                         sched.n_carry)
    assert torch.equal(run.x, want)
    with pytest.raises(ValueError, match="c_pad"):
        K.sptrsv_groups_stamped(ds.groups, c_pad[:, None], n=sched.n,
                                n_carry=sched.n_carry)


def test_the_card_profile_needs_the_card():
    sched, c = _schedules("lung2_like(0.05)/no_rewriting")
    with pytest.raises((ValueError, RuntimeError)):
        profile_schedule(sched, c, device="cpu", engine="cuda")


def test_packed_steps_carry_their_rows_and_deps():
    sched, _ = _schedules("lung2_like(0.05)/avgLevelCost")
    packed = K.pack_schedule(sched)
    lanes = K.unpack_tiles(packed)
    assert packed.step_rows.sum() == sched.n == packed.num_lanes
    assert packed.step_deps.sum() == packed.num_deps
    assert packed.step_rows[0] == packed.num_free
    step = lanes["step"]
    np.testing.assert_array_equal(packed.step_rows[1:],
                                  np.bincount(step)[1:])
    np.testing.assert_array_equal(
        packed.step_deps[1:],
        np.bincount(step, weights=np.diff(lanes["dep_ptr"]))[1:])
    assert packed.launches == 2


def test_calibrate_module_prints_the_fitted_constants(capsys):
    assert calibrate_mod.main(["--device", "cpu", "--scale", "0.02",
                               "--reps", "1", "--matrices",
                               "lung2_like"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["device"] == "cpu"
    cm = out["cost_model"]
    assert cm["step_overhead_us"] > 0
    assert cm["us_per_preamble_step"] == pytest.approx(
        cm["step_overhead_us"], rel=1e-9)
    assert cm["us_per_launch"] == 0.0
    assert out["profiles"]["lung2_like"]["engine"] == "stepwise"


def test_profiling_engine_solves_exactly():
    """As the reference's tests/test_obs.py holds its ProfilingEngine: the
    operator served through the stepwise profiler solves to 1e-4 of the
    float64 oracle and leaves a profile of the steps it ran."""
    from repro_torch.obs.profile import ProfilingEngine
    from repro_torch.solver.reference import solve_csr_seq
    L = generators.lung2_like(0.02)
    eng = ProfilingEngine()
    op = TriangularOperator.from_csr(L, tune="no_rewriting", cache=False,
                                     engine=eng, device="cpu")
    b = np.random.default_rng(1).standard_normal(L.n_rows)
    x = op.solve(b, max_refine=0)
    ref_x = solve_csr_seq(L, b)
    assert float(np.max(np.abs(np.asarray(x, np.float64) - ref_x))) < 1e-4
    prof = eng.last_profile
    assert prof is not None and prof.num_steps > 0
    assert prof.num_steps == op.schedule.num_steps
    assert eng.name == "profiled[stepwise]"


def test_profiling_engine_takes_its_base_engines_capabilities():
    from repro_torch.obs.profile import ProfilingEngine
    from repro_torch.solver.engines import get_engine
    cuda = get_engine("cuda")
    eng = ProfilingEngine(cuda)
    assert eng.dtypes == cuda.dtypes and eng.device_types == ("cuda",)
    assert eng.available() == cuda.available()
    assert eng.cache_token() == "profiled[cuda]:cuda"
    sched, _ = _schedules("lung2_like(0.05)/avgLevelCost")
    ts = transform(generators.lung2_like(0.05), AvgLevelCost(),
                   validate=False, codegen=False)
    assert eng.sweep_shape(ts, sched) == cuda.sweep_shape(ts, sched)
    # on a CPU-staged schedule it refuses, as the cuda engine does
    with pytest.raises((ValueError, RuntimeError)):
        eng.compile(to_device(sched, "cpu"))
    assert ProfilingEngine().sweep_shape(ts, sched) == \
        get_engine("torch").sweep_shape(ts, sched)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_stamped_x_equals_the_serving_kernels(cuda_device, name):
    sched, c = _schedules(name)
    packed = K.pack_schedule(sched).to(cuda_device)
    c_pad = pad_rhs(torch.as_tensor(c, dtype=torch.float32,
                                    device=cuda_device)).contiguous()
    run = K.sptrsv_groups_stamped(None, c_pad, n=sched.n,
                                  n_carry=sched.n_carry, packed=packed)
    x = K.sptrsv_groups(None, c_pad, n=sched.n, n_carry=sched.n_carry,
                        packed=packed)
    torch.cuda.synchronize()
    assert torch.equal(run.x, x)
    st = run.stamps.cpu().numpy()
    assert st.size == packed.num_steps - 1 + 2
    assert (np.diff(st) >= 0).all() and st[0] > 0
    free_ms, tile_ms = run.event_ms()
    assert free_ms > 0 and tile_ms > 0


@pytest.mark.cuda
def test_cuda_profile_steps_sum_to_the_launch(cuda_device):
    sched, c = _schedules("torso2_like(0.05)/no_rewriting")
    prof = profile_schedule(sched, c, reps=2, device=cuda_device)
    assert prof.engine == "cuda"
    assert prof.num_steps == len(prof.step_ms) == \
        K.pack_schedule(sched).num_steps
    assert abs(prof.stamped_ms / prof.event_ms - 1.0) <= 0.10
    assert prof.launch_us >= 0 and prof.clock_mhz > 0


@pytest.mark.cuda
def test_cuda_profiling_engine_serves_through_the_stamped_form(cuda_device):
    from repro_torch.obs.profile import ProfilingEngine
    from repro_torch.solver.engines import get_engine
    L = generators.lung2_like(0.05)
    op = TriangularOperator.from_csr(L, tune="no_rewriting", cache=False,
                                     device=cuda_device)
    b = np.random.default_rng(2).standard_normal(L.n_rows)
    want = op.solve(b, max_refine=0)
    eng = ProfilingEngine(get_engine("cuda"))
    before = K.LAUNCHES["sptrsv_groups_stamped"]
    x = op.solve(b, max_refine=0, engine=eng)
    assert K.LAUNCHES["sptrsv_groups_stamped"] > before
    np.testing.assert_array_equal(x, want)
    assert eng.last_profile.num_steps == op._staged().packed().num_steps


def test_profiling_engine_solves_a_batched_right_side():
    """solve(B) through the stepwise profiler: every column to 1e-4 of the
    float64 oracle."""
    from repro_torch.obs.profile import ProfilingEngine
    from repro_torch.solver.reference import solve_csr_seq
    L = generators.lung2_like(0.02)
    eng = ProfilingEngine()
    op = TriangularOperator.from_csr(L, tune="no_rewriting", cache=False,
                                     device="cpu")
    B = np.random.default_rng(3).standard_normal((L.n_rows, 3))
    X = np.asarray(op.solve(B, max_refine=0, engine=eng), np.float64)
    assert X.shape == B.shape
    for r in range(B.shape[1]):
        assert float(np.max(np.abs(X[:, r] - solve_csr_seq(L, B[:, r])))) \
            < 1e-4
    assert eng.last_profile.num_steps == op.schedule.num_steps


@pytest.mark.cuda
def test_cuda_profiling_engine_solves_a_batched_right_side(cuda_device):
    """The stamped form takes one column: solve(B) goes column by column,
    each as the serving kernel's batched solve gives it."""
    from repro_torch.obs.profile import ProfilingEngine
    from repro_torch.solver.engines import get_engine
    L = generators.lung2_like(0.05)
    op = TriangularOperator.from_csr(L, tune="no_rewriting", cache=False,
                                     device=cuda_device)
    B = np.random.default_rng(4).standard_normal((L.n_rows, 3))
    want = np.asarray(op.solve(B, max_refine=0))
    eng = ProfilingEngine(get_engine("cuda"))
    before = K.LAUNCHES["sptrsv_groups_stamped"]
    X = np.asarray(op.solve(B, max_refine=0, engine=eng))
    assert K.LAUNCHES["sptrsv_groups_stamped"] >= before + 3
    assert X.shape == B.shape
    np.testing.assert_allclose(X, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    assert eng.last_profile.num_steps == op._staged().packed().num_steps
