"""The port's sharded solves against the reference's, on the CPU.

Counterparts of tests/test_distributed.py.  In-process cases run in a
world of one gloo rank on a `HashStore` (made and destroyed by the
`world1` fixture, so nothing leaks into other tests); the reference runs
on JAX's one CPU device.  Worlds of 2 and 4 gloo ranks run the
reference's multi-device script on the port in a subprocess each
(`tests/_torch_sharded_world.py`, its ranks spawned, a file store under
the test's `tmp_path`), with a timeout, so that a rank that hangs fails
its test instead of stalling the suite.

Tolerances:
* x against the reference's `solve_sharded` (float32 in both): 1e-5
  relative to max|x| (the two sum a lane's deps in another order);
* x against the float64 oracle `solve_csr_seq`: 1e-3 relative to max|x|
  (the reference's bound for float32 sweeps);
* x at 2 and 4 ranks against x at one rank: 1e-6 relative to max|x|
  (the gathered updates are the same numbers; what may differ is the
  order in which a rank's block sums), and bitwise equal across the ranks
  of one world;
* the sharded matvec against `A.matvec`: 1e-5;
* IC(0)-PCG under one mesh: converged in under 100 iterations, true
  residual <= 1e-3.

`count_all_gathers` equals the reference's (`steps`, `families`,
`calls`) with `families == steps`, with and without carries.  Cases
marked `cuda` run on a card (a world of one, NCCL or gloo) and skip here;
JAX is imported only inside the tests that hold the port against the
reference.
"""
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import faults
from repro_torch.core.portfolio import (CPU_COST_MODEL, CostModel,
                                       StrategyPortfolio)
from repro_torch.iterative import bicgstab, cg, device_matvec, gmres
from repro_torch.kernels import sptrsv_level as K
from repro_torch.precond import Preconditioner
from repro_torch.solver import (ShardedEngine, TriangularOperator,
                                get_engine, registered_engines,
                                resolve_engine, schedule_for_csr,
                                sharded_engine, solve_csr_seq, sptrsv,
                                to_device)
from repro_torch.solver import distributed as D
from repro_torch.sparse import build_levels, generators

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
REF_RTOL = 1e-5
ORACLE_RTOL = 1e-3
WORLD_RTOL = 1e-6
WORLD_TIMEOUT_S = 300


@pytest.fixture(autouse=True)
def _fresh_caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "port"))
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "ref"))
    TriangularOperator.clear_memory_cache()
    Preconditioner.clear_pair_decisions()
    yield
    TriangularOperator.clear_memory_cache()


def _world_of_one(backend="gloo"):
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


@pytest.fixture
def world1():
    """A world of one gloo rank and its default mesh, destroyed after."""
    _world_of_one()
    try:
        yield D.default_mesh()
    finally:
        dist.destroy_process_group()


def _small(n=120, seed=7, chunk=32, max_deps=4):
    L = generators.random_lower(n, avg_offdiag=2.0, seed=seed, max_back=15)
    sched = schedule_for_csr(L, build_levels(L), chunk=chunk,
                             max_deps=max_deps)
    b = np.random.default_rng(0).standard_normal(n)
    return L, sched, b


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(x - ref).max() / max(1.0, np.abs(ref).max()))


# -- registry, mesh and facades (a world of one) ------------------------------

def test_default_mesh_needs_a_process_group():
    """No quiet world of one: without an initialized process group the
    default mesh, and the registered engine's compile, raise."""
    if dist.is_initialized():
        dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="init_process_group"):
        D.default_mesh()
    _, sched, _ = _small()
    with pytest.raises(RuntimeError, match="process group"):
        get_engine("sharded").compile(sched)


def test_sharded_engine_registered_and_resolvable(world1):
    assert set(registered_engines()) == {"cuda", "sharded", "torch"}
    eng = resolve_engine("sharded")
    assert isinstance(eng, ShardedEngine)
    caps = eng.capabilities()
    assert caps["supports_batched_rhs"] and caps["available"]
    assert not eng.plain and eng.collective_mesh() == (world1, "model")
    assert eng.pack_device(torch.device("cpu")) is None   # no K1 tiles
    assert sharded_engine() is eng
    assert resolve_engine(mesh=world1) is eng
    with pytest.raises(ValueError, match="not both"):
        resolve_engine("torch", mesh=world1)


def test_sharded_cache_token_is_mesh_qualified(world1):
    e1 = ShardedEngine(world1)
    assert e1.cache_token() == "sharded[model:gloo:cpu:1:0]"
    assert get_engine("torch").cache_token() == "torch"
    other = ShardedEngine(D.default_mesh(axis="data"), axis="data")
    assert other.cache_token() != e1.cache_token()


def test_sharded_engine_default_mesh_unifies_with_registry(world1):
    eng = get_engine("sharded")
    assert D.default_mesh() is world1
    assert sharded_engine(world1) is eng and sharded_engine(None) is eng
    other = D.default_mesh(axis="data")
    assert sharded_engine(other, "data") is sharded_engine(other, "data")
    assert sharded_engine(other, "data") is not eng
    # a default mesh of another device type than the backend's default is
    # no default: its engine stages where that mesh does
    meta = D.default_mesh(device_type="meta")
    assert meta is not world1 and D.default_mesh(device_type="meta") is meta
    assert sharded_engine(meta) is not eng
    assert sharded_engine(meta).placement() == torch.device("meta")


def test_a_mesh_that_is_no_device_mesh_raises_type_error():
    L, sched, b = _small()
    A = generators.poisson2d_spd(6, 5)
    from repro_torch.precond import factorize
    for call in (
            lambda: TriangularOperator.from_csr(L, mesh=object(),
                                                cache=False),
            lambda: sptrsv(L, b, mesh=object()),
            lambda: device_matvec(A, mesh=object()),
            lambda: Preconditioner.from_factors(
                factorize.ic0(A), tune="no_rewriting", mesh=object()),
            lambda: D.count_all_gathers(sched, object()),
            lambda: ShardedEngine(object())):
        with pytest.raises(TypeError, match="DeviceMesh"):
            call()


def test_device_disagreeing_with_the_mesh_raises(world1):
    L, _, _ = _small()
    with pytest.raises(ValueError, match="disagrees with the mesh"):
        TriangularOperator.from_csr(L, "no_rewriting", mesh=world1,
                                    device="cuda", cache=False)
    op = TriangularOperator.from_csr(L, "no_rewriting", mesh=world1,
                                     device="cpu", cache=False)
    assert op.device == torch.device("cpu") and op.engine == "sharded"


def test_mesh_auto_tune_defaults_to_sharded_cost_model(world1, tmp_path):
    L = generators.random_lower(120, avg_offdiag=2.0, seed=4, max_back=12)
    op = TriangularOperator.from_csr(L, tune="auto", chunk=32, max_deps=4,
                                     mesh=world1, cache_dir=tmp_path)
    assert op.report.cost_model == CostModel.sharded(base=CPU_COST_MODEL)
    assert op.report.cost_model.collective_latency_us == 5.0
    for c in op.report.candidates:
        if c.error is None:
            # one barrier a step of the schedule and of its preamble
            assert c.breakdown["collectives_us"] == \
                pytest.approx((c.steps + c.preamble_steps) * 5.0)
    op2 = TriangularOperator.from_csr(L, tune="auto", chunk=32, max_deps=4,
                                      device="cpu", cache_dir=tmp_path)
    assert op2.report.cost_model.collective_latency_us == 0
    assert op2.stats.cache_source == "built"     # distinct objectives
    op3 = TriangularOperator.from_csr(L, tune="auto", chunk=32, max_deps=4,
                                      mesh=world1, cache=False,
                                      cost_model=CostModel())
    assert op3.report.cost_model.collective_latency_us == 0


def test_sharded_operator_never_stages_unpadded_schedules(world1):
    """The sharded engine lowers from the host schedule: no unpadded
    DeviceSchedule, no preamble staging, no packed form of K1's, for the
    main schedule and the T-factor preamble alike."""
    L = generators.lung2_like(scale=0.02)
    op = TriangularOperator.from_csr(L, tune="avgLevelCost", chunk=32,
                                     max_deps=4, mesh=world1, cache=False)
    b = np.random.default_rng(5).standard_normal(L.n_rows)
    x = op.solve(b, max_refine=0)
    y = op.device_solve_fn()(torch.as_tensor(b, dtype=torch.float32))
    x_ref = solve_csr_seq(L, b)
    assert _rel(x, x_ref) < ORACLE_RTOL and _rel(y.numpy(), x_ref) < \
        ORACLE_RTOL
    assert op._runtime.get("dsched") is None
    assert op._runtime.get("preamble") is None
    assert op._payload["preamble"][0] is not None
    assert "packed" not in op._payload
    assert "preamble_packed" not in op._payload
    assert op.solve(b) is not None and op.stats.last_residual <= 1e-10
    assert op.stats.fallbacks == 0


def test_mesh_pair_decision_defaults_to_sharded_cost_model(world1):
    A = generators.poisson2d_spd(10, 10)
    P = Preconditioner.ic0(A, tune="auto", mesh=world1, cache=False)
    assert P.forward.engine == P.backward.engine == "sharded"
    assert P.report.fwd.cost_model.collective_latency_us > 0
    r = np.random.default_rng(4).standard_normal(A.n_rows)
    z = P.device_apply()(torch.as_tensor(r, dtype=torch.float32))
    L = P.factors.L.to_dense()
    assert _rel(z.numpy(), np.linalg.solve(L @ L.T, r)) < ORACLE_RTOL


def test_sharded_solves_single_and_batched(world1):
    L, sched, b = _small()
    fn = get_engine("sharded").compile(sched)
    x = fn(torch.as_tensor(b, dtype=torch.float32))
    assert x.dtype == torch.float32
    assert _rel(x.numpy(), solve_csr_seq(L, b)) < ORACLE_RTOL
    B = np.random.default_rng(1).standard_normal((L.n_rows, 3))
    X = fn(torch.as_tensor(B, dtype=torch.float32)).numpy()
    assert X.shape == (L.n_rows, 3)
    for j in range(3):
        assert _rel(X[:, j], solve_csr_seq(L, B[:, j])) < ORACLE_RTOL


def test_sharded_mismatched_rhs_raises(world1):
    _, sched, _ = _small()
    fn = get_engine("sharded").compile(sched)
    n = sched.n
    with pytest.raises(ValueError, match=rf"\({n},\) or \({n}, k\)"):
        fn(np.zeros(n + 1, np.float32))
    with pytest.raises(ValueError, match="right-hand side"):
        fn(np.zeros((n - 1, 2), np.float32))
    with pytest.raises(ValueError, match="right-hand side"):
        fn(np.zeros((n, 2, 2), np.float32))


def test_axis_name_mismatch_is_a_clear_error(world1):
    mesh = D.default_mesh(axis="data")
    with pytest.raises(ValueError, match=r"no axis 'model'.*'data'"):
        ShardedEngine(mesh)
    L, sched, b = _small()
    with pytest.raises(ValueError, match="no axis"):
        D.solve_sharded(sched, b, mesh)
    with pytest.raises(ValueError, match="no axis"):
        TriangularOperator.from_csr(L, tune="no_rewriting", chunk=32,
                                    max_deps=4, mesh=mesh, cache=False)
    with pytest.raises(ValueError, match="no axis"):
        device_matvec(L, mesh=mesh)
    with pytest.raises(ValueError, match="no axis"):
        D.count_all_gathers(sched, mesh)


def test_sharded_compile_memoizes_lowering(world1, monkeypatch):
    _, sched, _ = _small()
    calls = {"pad": 0}
    real_pad = D._pad_group

    def counting_pad(*a, **kw):
        calls["pad"] += 1
        return real_pad(*a, **kw)

    monkeypatch.setattr(D, "_pad_group", counting_pad)
    eng = ShardedEngine()
    fn1 = eng.compile(sched)
    pads = calls["pad"]
    assert pads > 0
    assert eng.compile(sched) is fn1
    assert eng.compile(to_device(sched, "cpu")) is fn1   # .host resolves
    assert calls["pad"] == pads
    _, other, _ = _small(seed=11)
    assert eng.compile(other) is not fn1 and calls["pad"] > pads


def test_solve_sharded_reuses_engine_lowering(world1):
    L, sched, b = _small()
    x = D.solve_sharded(sched, b, world1)
    assert _rel(x, solve_csr_seq(L, b)) < ORACLE_RTOL
    eng = sharded_engine(world1)
    fn = eng.compile(sched)             # a memo hit from solve_sharded's
    assert eng.compile(sched) is fn and len(eng._lowered) == 1


def test_sptrsv_under_a_mesh_with_gradients(world1):
    """Forward against the oracle; the backward solves the flipped system
    under the same mesh, so the gradient is A^-T w."""
    L = generators.lung2_like(0.02)
    b = np.random.default_rng(6).standard_normal(L.n_rows)
    w = np.random.default_rng(7).standard_normal(L.n_rows)
    bt = torch.tensor(b, requires_grad=True)
    x = sptrsv(L, bt, mesh=world1)
    assert _rel(x.detach().numpy(), solve_csr_seq(L, b)) < 1e-10
    (g,) = torch.autograd.grad((x * torch.as_tensor(w)).sum(), bt)
    op = TriangularOperator.from_csr(L, "no_rewriting", transpose=True,
                                     device="cpu")
    assert _rel(g.numpy(), op.solve(w)) < 1e-10
    fwd = TriangularOperator.from_csr(L, "no_rewriting", mesh=world1)
    assert fwd.stats.cache_source == "memory" and fwd.engine == "sharded"
    assert fwd.transposed().engine == "sharded"


def test_ilu0_krylov_under_one_mesh(world1):
    """ILU(0)-BiCGStab and -GMRES with the matvec and both sweeps under one
    mesh converge as they do on one device."""
    A = generators.poisson2d_spd(10, 10)
    rng = np.random.default_rng(7)
    from repro_torch.sparse.csr import CSR
    N = CSR(indptr=A.indptr, indices=A.indices,
            data=A.data + 0.25 * rng.uniform(-1, 1, A.nnz), shape=A.shape)
    b = torch.as_tensor(N.matvec(rng.standard_normal(N.n_rows)))
    P = Preconditioner.ilu0(N, tune="no_rewriting", mesh=world1,
                            cache=False)
    assert P.forward.engine == P.backward.engine == "sharded"
    for solver, kw in ((bicgstab, {}), (gmres, {"restart": 20})):
        res = solver(N, b, preconditioner=P, tol=1e-8, mesh=world1, **kw)
        r = b.numpy() - N.matvec(res.x.numpy())
        assert bool(res.converged)
        assert np.linalg.norm(r) <= 1e-6 * np.linalg.norm(b.numpy())


def test_solve_service_refuses_a_mesh(world1):
    from repro_torch.serving import OperatorRegistry
    for kw in ({"mesh": world1}, {"engine": "sharded"},
               {"engine": get_engine("sharded")}):
        with pytest.raises(ValueError, match="sharded"):
            OperatorRegistry(device="cpu", **kw)


# -- the collective count and the answers against the reference --------------

def _ref_schedules(kind):
    from repro.solver import schedule_for_csr as ref_sched
    from repro.sparse import build_levels as ref_levels
    from repro.sparse import generators as ref_gen
    if kind == "carry":
        L, Lr = generators.banded(160, 12, seed=1), \
            ref_gen.banded(160, 12, seed=1)
        kw = {"chunk": 16, "max_deps": 4}
    else:
        L = generators.random_lower(120, avg_offdiag=2.0, seed=7,
                                    max_back=15)
        Lr = ref_gen.random_lower(120, avg_offdiag=2.0, seed=7, max_back=15)
        kw = {"chunk": 32, "max_deps": 4}
    return (L, schedule_for_csr(L, build_levels(L), **kw),
            ref_sched(Lr, ref_levels(Lr), **kw))


@pytest.mark.parametrize("kind", ["plain", "carry"])
def test_count_all_gathers_matches_reference(kind):
    """One all_gather family per step, and the reference's raw call count
    (4 per step on a schedule with carries, 2 without)."""
    from repro.solver.distributed import count_all_gathers as ref_count
    _, sched, ref_sched = _ref_schedules(kind)
    got, want = D.count_all_gathers(sched), ref_count(ref_sched)
    assert got == want
    assert got["families"] == got["steps"] == sched.num_steps
    if kind == "carry":
        assert sched.n_carry > 0 and got["calls"] == 4 * got["steps"]


@pytest.mark.parametrize("kind", ["single", "batched", "carry"])
def test_sharded_x_matches_reference_in_one_rank(world1, kind):
    import jax
    from repro.solver.distributed import default_mesh as ref_mesh
    from repro.solver.distributed import solve_sharded as ref_solve
    L, sched, ref_sched = _ref_schedules("carry" if kind == "carry"
                                         else "plain")
    rng = np.random.default_rng(2)
    b = rng.standard_normal((L.n_rows, 3) if kind == "batched"
                            else L.n_rows)
    x = D.solve_sharded(sched, b, world1)
    x_ref = ref_solve(ref_sched, b, ref_mesh(devices=jax.devices()[:1]))
    assert x.shape == b.shape and x.dtype == np.float32
    assert _rel(x, x_ref) < REF_RTOL
    cols = b.reshape(L.n_rows, -1).T
    xs = x.reshape(L.n_rows, -1).T
    for bj, xj in zip(cols, xs):
        assert _rel(xj, solve_csr_seq(L, bj)) < ORACLE_RTOL


def _run_world(world: int, out: Path) -> list:
    """Run one spawned world; (npz, json) per rank.  The launcher and its
    ranks share a session of their own, so a timeout kills them all."""
    out.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_sharded_world.py"),
         str(world), str(out)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=ROOT, start_new_session=True)
    try:
        _, err = proc.communicate(timeout=WORLD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    assert proc.returncode == 0, err[-3000:]
    return [(np.load(out / f"rank{r}.npz"),
             json.loads((out / f"rank{r}.json").read_text()))
            for r in range(world)]


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_worlds(world, tmp_path):
    """The reference's multi-device script on 2 and 4 gloo ranks: the same
    x on every rank, bitwise, within 1e-6 of one rank's and 1e-5 of the
    reference's; fewer steps, fewer families; the one-mesh PCG; the
    tuner's measured pick taken from rank 0 on every rank; a disk hit on
    one rank alone, and a lowering failed on one rank alone, decided
    alike on every rank."""
    import jax
    from repro.solver.distributed import default_mesh as ref_mesh
    from repro.solver.distributed import solve_sharded as ref_solve
    ranks = _run_world(world, tmp_path / f"world{world}")
    arrs0, res0 = ranks[0]
    for arrs, res in ranks[1:]:
        assert res == res0
        for k in arrs0.files:
            assert np.array_equal(arrs[k], arrs0[k]), k
    # one rank, in this process, on the same inputs
    _world_of_one()
    try:
        mesh = D.default_mesh()
        L = generators.random_lower(400, avg_offdiag=2.0, seed=3,
                                    max_back=24)
        b = np.random.default_rng(0).standard_normal(400)
        sched = schedule_for_csr(L, build_levels(L), chunk=32, max_deps=4,
                                 dtype=np.float32)
        x1 = D.solve_sharded(sched, b, mesh)
        Lb = generators.banded(160, 12, seed=1)
        sb = schedule_for_csr(Lb, build_levels(Lb), chunk=16, max_deps=4)
        bb = np.random.default_rng(1).standard_normal(160)
        xb1 = D.solve_sharded(sb, bb, mesh)
    finally:
        dist.destroy_process_group()
    from repro.solver import schedule_for_csr as ref_sched
    from repro.sparse import build_levels as ref_levels
    from repro.sparse import generators as ref_gen
    Lr = ref_gen.random_lower(400, avg_offdiag=2.0, seed=3, max_back=24)
    x_ref = ref_solve(ref_sched(Lr, ref_levels(Lr), chunk=32, max_deps=4),
                      b, ref_mesh(devices=jax.devices()[:1]))
    assert _rel(arrs0["x"], x1) < WORLD_RTOL
    assert _rel(arrs0["x"], x_ref) < REF_RTOL
    assert _rel(arrs0["x"], solve_csr_seq(L, b)) < ORACLE_RTOL
    assert _rel(arrs0["x_transformed"], solve_csr_seq(L, b)) < ORACLE_RTOL
    assert res0["n_carry"] > 0
    assert _rel(arrs0["x_carry"], xb1) < WORLD_RTOL
    assert _rel(arrs0["x_carry"], solve_csr_seq(Lb, bb)) < ORACLE_RTOL
    B = np.random.default_rng(2).standard_normal((400, 3))
    for j in range(3):
        assert _rel(arrs0["X"][:, j], solve_csr_seq(L, B[:, j])) < \
            ORACLE_RTOL
    assert res0["memoized"]
    # the paper's claim, made literal: fewer steps, fewer barriers
    assert res0["steps1"] <= res0["steps0"]
    for key, steps in (("gathers0", "steps0"), ("gathers1", "steps1")):
        assert res0[key]["families"] == res0[key]["steps"] == res0[steps]
    assert res0["gathers_carry"]["families"] == \
        res0["gathers_carry"]["steps"]
    A = generators.poisson2d_spd(12, 12)
    rhs = np.random.default_rng(3).standard_normal(A.n_rows)
    assert _rel(arrs0["spmv"], A.matvec(rhs)) < 1e-5
    assert res0["engines"] == ["sharded", "sharded"]
    assert res0["pcg_converged"] and 0 < res0["pcg_iters"] < 100
    assert np.abs(rhs - A.matvec(arrs0["pcg_x"].astype(np.float64))).max() \
        <= 1e-3
    # rank 0's timings favour fewer steps, the others' more: every rank
    # took rank 0's pick, and the measured candidates did differ
    assert len(set(res0["measured_steps"])) > 1
    assert res0["tuned_steps"] == min(res0["measured_steps"])
    assert res0["agree"] == 0
    assert _rel(arrs0["x_tuned"], solve_csr_seq(L, b)) < 1e-10
    # rank 0 held a disk hit the others did not: every rank built, and
    # took rank 0's pick (no rank left waiting in the tuner's broadcast)
    assert res0["split_cache_source"] == "built"
    assert res0["split_cache_steps"] == res0["tuned_steps"]
    assert _rel(arrs0["x_split_cache"], solve_csr_seq(L, b)) < 1e-10
    # the lowering failed on the last rank alone: every rank fell back
    # to the plain body together, warned, with the same answer
    assert res0["lost_on_one_fallback"] == "sharded->torch"
    assert res0["lost_on_one_compile_failed"]
    assert res0["lost_on_one_warnings"] == ["EngineFallbackWarning"]
    assert _rel(arrs0["x_lost_on_one"], solve_csr_seq(L, b)) < 1e-10


# -- the profiler and the cost model ------------------------------------------

def test_profile_schedule_with_mesh_fills_collective_ms(world1):
    from repro_torch.obs.profile import (ProfilingEngine, profile_operator,
                                         profile_schedule)
    L, sched, b = _small()
    prof = profile_schedule(sched, b, mesh=world1, reps=1, warmup=0)
    assert prof.engine == "sharded" and prof.num_steps == sched.num_steps
    assert prof.collective_ms is not None
    assert prof.collective_ms.shape == prof.step_ms.shape
    assert (prof.collective_ms >= 0).all()
    assert (prof.collective_ms <= prof.step_ms).all()
    op = TriangularOperator.from_csr(L, "no_rewriting", chunk=32,
                                     max_deps=4, mesh=world1, cache=False)
    assert profile_operator(op, reps=1).collective_ms is not None
    assert op._runtime.get("dsched") is None
    pe = ProfilingEngine(get_engine("sharded"))
    x = pe.compile(sched)(torch.as_tensor(b, dtype=torch.float32))
    assert _rel(x.numpy(), solve_csr_seq(L, b)) < ORACLE_RTOL
    assert pe.last_profile.collective_ms is not None
    cm = CostModel.sharded().calibrate(prof)
    assert cm.collective_latency_us == pytest.approx(
        float(np.median(prof.collective_ms)) * 1e3)


def test_cost_model_calibrate_collective_split():
    from repro_torch.obs.profile import ScheduleProfile
    flops = np.array([1000, 2000, 3000, 4000], dtype=np.int64)
    coll_ms = np.array([0.004, 0.005, 0.006, 0.005])
    comp_us = 2.0 + 1e-3 * flops
    prof = ScheduleProfile(
        engine="sharded", num_steps=4, reps=1,
        step_ms=comp_us / 1e3 + coll_ms, collective_ms=coll_ms,
        step_padded_flops=flops, step_real_flops=flops,
        step_bytes=np.full(4, 64.0), width_buckets=[])
    cm = CostModel.sharded().calibrate(prof)
    assert cm.collective_latency_us == pytest.approx(5.0)
    assert cm.us_per_padded_flop == pytest.approx(1e-3, rel=1e-6)


def test_cost_model_collective_term_ranks_by_steps():
    """A per-step collective charge high enough to dominate ranks the
    candidates by step count, and the transformation wins: its point is
    fewer synchronization steps."""
    L = generators.lung2_like(0.05)
    cm = CostModel.sharded(collective_latency_us=1e4)
    assert cm.collective_latency_us == 1e4
    rep = StrategyPortfolio(chunk=128, max_deps=8, cost_model=cm,
                            device="cpu").tune(L)
    ok = [c for c in rep.candidates if c.error is None]
    for c in ok:
        assert c.breakdown["collectives_us"] == pytest.approx(c.steps * 1e4)
    steps = [c.steps for c in ok]
    assert steps == sorted(steps)
    assert rep.best.steps <= min(c.steps for c in ok
                                 if c.label == "no_rewriting")


def test_sharded_cost_model_charges_the_preamble_barriers(world1):
    """The sharded lowering runs the T-factor preamble's schedule too, one
    all_gather family a step, so a rewrite whose main schedule has fewer
    steps than no_rewriting's, but whose main and preamble steps together
    have more, is not preferred (torso2_like(0.02), chunk 32: avgLevelCost
    443 + 274 steps against 513), on a CPU mesh and on a card's."""
    from repro_torch.core.portfolio import (SHARDED_CUDA_BASE,
                                           default_cost_model_for)
    eng = sharded_engine(world1)
    card = default_cost_model_for(sharded_engine(
        D.default_mesh(device_type="meta")))
    assert card == CostModel.sharded(base=SHARDED_CUDA_BASE)
    assert card.us_per_preamble_step == card.step_overhead_us > 0
    L = generators.torso2_like(0.02)
    for cm in (default_cost_model_for(eng), card):
        rep = StrategyPortfolio(chunk=32, max_deps=4, cost_model=cm,
                                engine=eng, device="cpu").tune(L)
        ok = {c.label: c for c in rep.candidates if c.error is None}
        base = ok["no_rewriting"]
        heavy = [c for c in ok.values()
                 if c.steps < base.steps < c.steps + c.preamble_steps]
        assert "avgLevelCost" in {c.label for c in heavy}
        for c in heavy:
            assert c.breakdown["collectives_us"] == pytest.approx(
                (c.steps + c.preamble_steps) * cm.collective_latency_us)
            assert c.predicted_us > base.predicted_us, c.label


def test_sharded_sweep_shape_is_the_padded_schedules(world1):
    from repro_torch.core import NoRewrite, transform
    from repro_torch.solver import schedule_for_transformed
    L = generators.lung2_like(0.02)
    ts = transform(L, NoRewrite(), validate=False, codegen=False)
    sched = schedule_for_transformed(ts, chunk=32, max_deps=4)
    shape = get_engine("sharded").sweep_shape(ts, sched)
    padded = D._padded_schedule(sched, 1)
    assert shape["steps"] == padded.num_steps == sched.num_steps
    assert shape["barriers"] == shape["steps"] + shape["preamble_steps"]
    assert shape["padded_flops"] == padded.padded_flops()


# -- a lost mesh --------------------------------------------------------------

def test_lose_mesh_downgrades_sharded_to_torch_on_the_cpu(world1):
    L, _, b = _small()
    with faults.lose_mesh():
        op = TriangularOperator.from_csr(L, cache=False, mesh=world1,
                                         tune="no_rewriting")
        with pytest.warns(Warning, match="mesh"):
            x = op.solve(b)
    assert op.stats.last_fallback == "sharded->torch"
    assert _rel(x, solve_csr_seq(L, b)) < 1e-10
    assert "packed" not in op._payload


# -- on a card (skip here) ----------------------------------------------------

@pytest.fixture
def nccl_world1():
    """An NCCL world of one on the card and its mesh, destroyed after."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.cuda.set_device(0)
    _world_of_one("nccl")
    try:
        yield D.default_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_sharded_operator_on_the_card(nccl_world1):
    """from_csr(mesh=) on the card: staged on cuda:{current}, answers
    within the gates, one family per step, no K1 launch, no pack."""
    L = generators.lung2_like(0.05)
    b = np.random.default_rng(8).standard_normal(L.n_rows)
    before = dict(K.LAUNCHES)
    op = TriangularOperator.from_csr(L, "avgLevelCost", mesh=nccl_world1,
                                     cache=False)
    assert op.device.type == "cuda" and op.engine == "sharded"
    x0 = op.solve(b, max_refine=0)
    assert _rel(x0, solve_csr_seq(L, b)) < ORACLE_RTOL
    op.solve(b)
    assert op.stats.last_residual <= 1e-10
    assert op.verify(collectives=True).collective_families == \
        op.schedule.num_steps
    assert dict(K.LAUNCHES) == before
    assert "packed" not in op._payload
    A = generators.spd_from_lower(generators.lung2_like(0.05), seed=0)
    mv = device_matvec(A, mesh=nccl_world1)
    rhs = np.random.default_rng(9).standard_normal(A.n_rows)
    y = mv(torch.as_tensor(rhs, device=op.device))
    assert _rel(y.cpu().numpy(), A.matvec(rhs)) < 1e-12
    P = Preconditioner.ic0(A, tune="no_rewriting", mesh=nccl_world1,
                           cache=False)
    res = cg(mv, torch.as_tensor(A.matvec(rhs), device=op.device),
             preconditioner=P, tol=1e-8)
    assert bool(res.converged)


@pytest.mark.cuda
def test_cuda_gloo_sharded_engine_stages_on_the_card():
    """The card unless the caller asks for the CPU, whatever the backend:
    under a gloo world, engine="sharded" with no device= and no mesh=
    builds its default mesh on CUDA and stages on cuda:0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.cuda.set_device(0)
    _world_of_one("gloo")
    try:
        L, _, b = _small()
        op = TriangularOperator.from_csr(L, "no_rewriting", chunk=32,
                                         max_deps=4, engine="sharded",
                                         cache=False)
        assert D.default_mesh().device_type == "cuda"
        assert op.device == torch.device("cuda", 0)
        assert op.engine == "sharded" and "packed" not in op._payload
        x = op.solve(b)
        assert op.stats.fallbacks == 0 and op.stats.last_residual <= 1e-10
        assert _rel(x, solve_csr_seq(L, b)) < 1e-10
        cpu = TriangularOperator.from_csr(
            L, "no_rewriting", chunk=32, max_deps=4, cache=False,
            mesh=D.default_mesh(device_type="cpu"))
        assert cpu.device == torch.device("cpu")
    finally:
        dist.destroy_process_group()
