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
import gc
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
    """A world of one gloo rank and its default mesh, destroyed after.
    The earlier tests' garbage is collected first, so that none of their
    schedules dies during this test (leaving a dead entry in the
    registered sharded engine's memo, which drops such entries when it
    next adds one)."""
    gc.collect()
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
    """A right-hand side the call refuses raises the agreed typed error
    (one rank here), naming the rank and the check's ValueError."""
    _, sched, _ = _small()
    fn = get_engine("sharded").compile(sched)
    n = sched.n
    with pytest.raises(D.ShardedCallError,
                       match=rf"rank 0: its input check: ValueError: .*"
                             rf"\({n},\) or \({n}, k\)") as info:
        fn(np.zeros(n + 1, np.float32))
    assert isinstance(info.value.__cause__, ValueError)
    assert info.value.rank == 0
    with pytest.raises(D.ShardedCallError, match="right-hand side"):
        fn(np.zeros((n - 1, 2), np.float32))
    with pytest.raises(D.ShardedCallError, match="right-hand side"):
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


def _serving_batches(tracer):
    return [{k: v for k, v in sp.attrs.items()
             if k not in ("pattern", "solve_ms")}
            for sp in tracer.spans() if sp.name == "serving.batch"]


def test_solve_service_refuses_a_mesh(world1):
    """Named for the contract it replaced: the service now SERVES under a
    mesh (`mesh=`, engine="sharded" by name or instance), through the
    sharded engine, forming the single-device service's batches in pump
    mode with answers within 1e-5 of its answers."""
    from _torch_sharded_world import pump_requests
    from repro_torch import obs
    from repro_torch.serving import OperatorRegistry, SolveService
    from repro_torch.serving.server import step_values
    for kw in ({"mesh": world1}, {"engine": "sharded"},
               {"engine": get_engine("sharded")}):
        reg = OperatorRegistry(**kw)
        assert reg.mesh[0] is world1 and reg.mesh[1] == "model"
        reg.close()
    requests = pump_requests(generators, step_values)
    kw = dict(max_width=4, max_linger_s=60.0, auto_dispatch=False,
              tune_mode="off", cache=False)
    out = {}
    for name, extra in (("mesh", {"mesh": world1}), ("one", {"device":
                                                             "cpu"})):
        tr = obs.enable()
        with SolveService(**kw, **extra) as svc:
            futs = [svc.submit(b, M, **k) for M, b, k in requests]
            assert svc.pump() == 5
            xs = [f.result(timeout=0) for f in futs]
            snap = svc.snapshot()
            engines = {e.op.engine for _, e in svc.registry.entries()}
        obs.disable()
        out[name] = (xs, _serving_batches(tr), snap, engines)
    (xs, batches, snap, engines), (xs1, batches1, snap1, _) = \
        out["mesh"], out["one"]
    assert engines == {"sharded"}
    assert batches == batches1
    for x, x1 in zip(xs, xs1, strict=True):
        assert _rel(x, x1) <= REF_RTOL
    assert snap["mesh"] == {"size": 1, "rank": 0, "role": "front",
                            "commands": 8, "failed_commands": {},
                            "last_error": ""}
    assert "mesh" not in snap1
    for k in ("submitted", "completed", "batches", "width_hist"):
        assert snap[k] == snap1[k], k


def test_mesh_service_issues_every_collective_from_one_thread(
        world1, monkeypatch):
    """Auto mode under a mesh, stressed: 8 submitter threads over two
    patterns with background tunes and a shortened switch interval.
    Every all_gather comes from the one mesh thread, every answer is
    within 5e-5 of the float64 oracle, nothing is dropped, and each
    pattern's tune ran once, as a command between batches."""
    import sys
    import threading
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.serving import SolveService
    from repro_torch.serving.server import step_values
    threads = set()
    real = dist.all_gather_into_tensor

    def gather(*args, **kwargs):
        threads.add(threading.get_ident())
        return real(*args, **kwargs)

    monkeypatch.setattr(dist, "all_gather_into_tensor", gather)
    mats = [generators.lung2_like(0.02), generators.torso2_like(0.02)]
    mats += [step_values(M, 1) for M in mats]
    reqs = [(mats[i % 4], np.random.default_rng(i).standard_normal(
        mats[i % 4].n_rows)) for i in range(40)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with SolveService(mesh=world1, max_width=4, max_linger_s=0.002,
                          tenant_cap=None, tune_mode="background",
                          cache=False) as svc:
            with ThreadPoolExecutor(8) as pool:
                futs = list(pool.map(lambda r: svc.submit(r[1], r[0]),
                                     reqs))
            xs = [f.result(timeout=120) for f in futs]
            assert svc.wait_warm(timeout=120)
            snap = svc.snapshot()
            log = list(svc.mesh_log)
    finally:
        sys.setswitchinterval(interval)
    assert len(threads) == 1 and threading.get_ident() not in threads
    for (M, b), x in zip(reqs, xs):
        ref = solve_csr_seq(M, b)
        assert np.abs(np.asarray(x, np.float64) - ref).max() <= \
            5e-5 * max(1.0, np.abs(ref).max())
    assert snap["completed"] == snap["submitted"] == 40
    assert snap["registry"]["hot_swaps"] == 2
    kinds = [k for k, _ in log]
    assert kinds.count("tune") == 2 and kinds.count("admit") == 2
    assert kinds.count("batch") == snap["batches"]


def test_service_under_one_mesh_matches_the_reference(world1):
    """A world of one: the port's service under a mesh against the
    reference's `SolveService(mesh=default_mesh())` on the same requests:
    the same batches, answers within 1e-5 relative to max|x|."""
    import jax
    from _torch_sharded_world import pump_requests
    from repro import obs as ref_obs
    from repro.serving import SolveService as RefService
    from repro.serving.server import step_values as ref_step
    from repro.solver.distributed import default_mesh as ref_mesh
    from repro.sparse import generators as ref_gen
    from repro_torch import obs
    from repro_torch.serving import SolveService
    from repro_torch.serving.server import step_values
    kw = dict(max_width=4, max_linger_s=60.0, auto_dispatch=False,
              tune_mode="off", cache=False)
    tr = obs.enable()
    with SolveService(mesh=world1, **kw) as svc:
        futs = [svc.submit(b, M, **k)
                for M, b, k in pump_requests(generators, step_values)]
        svc.pump()
        xs = [f.result(timeout=0) for f in futs]
    obs.disable()
    ref_tr = ref_obs.enable()
    try:
        with RefService(mesh=ref_mesh(devices=jax.devices()[:1]),
                        **kw) as ref_svc:
            futs = [ref_svc.submit(b, M, **k)
                    for M, b, k in pump_requests(ref_gen, ref_step)]
            ref_svc.pump()
            ref_xs = [f.result(timeout=0) for f in futs]
    finally:
        ref_obs.disable()
    assert _serving_batches(tr) == _serving_batches(ref_tr)
    for x, x_ref in zip(xs, ref_xs, strict=True):
        assert _rel(x, x_ref) <= REF_RTOL


def test_one_rank_step_failure_is_raised_not_downgraded(world1):
    """A sharded call that fails at a step raises ShardedCallError naming
    the rank and the step, down no fallback chain; the lowering stays
    memoized and the next call serves."""
    L, sched, b = _small()
    fn = get_engine("sharded").compile(sched)
    x = fn(b).numpy()
    with faults.fail_sharded_step(step=2):
        with pytest.raises(D.ShardedCallError,
                           match="rank 0: step 2: RuntimeError") as info:
            fn(b)
    assert info.value.failures == [(0, info.value.reason)]
    with faults.fail_sharded_step(step=2, stage="publish"):
        with pytest.raises(D.ShardedCallError, match=r"step 2: RuntimeError"
                           r": .*\(publish\)"):
            fn(b)
    assert np.array_equal(fn(b).numpy(), x)
    assert get_engine("sharded").compile(sched) is fn
    assert np.array_equal(fn(b).numpy(), x)
    op = TriangularOperator.from_csr(L, tune="no_rewriting", chunk=32,
                                     max_deps=4, mesh=world1, cache=False)
    with faults.fail_sharded_step(step=1):
        with pytest.raises(D.ShardedCallError, match="step 1"):
            op.solve(b)
    assert op.stats.fallbacks == 0 and op.stats.last_fallback == ""
    assert "sharded" not in op._runtime.get("engine_failures", {})
    assert _rel(op.solve(b), solve_csr_seq(L, b)) < 1e-10


def test_settle_agrees_what_one_rank_raised(world1):
    """`settle` returns fn's value, turns what fn raised into a
    ShardedCallError naming the rank and where, and raises a
    ShardedCallError fn raised (agreed already) as it is."""
    assert D.settle(lambda: 7, "its step", world1) == 7

    def oom():
        raise MemoryError("out of memory")

    with pytest.raises(D.ShardedCallError,
                       match="rank 0: its step: MemoryError: out of "
                             "memory") as info:
        D.settle(oom, "its step", world1)
    assert isinstance(info.value.__cause__, MemoryError)
    agreed = D.ShardedCallError([(0, "step 1: RuntimeError: x")])

    def raises():
        raise agreed

    with pytest.raises(D.ShardedCallError) as info:
        D.settle(raises, "its solve", world1)
    assert info.value is agreed
    with pytest.raises(ValueError, match="stage"):
        with faults.fail_sharded_step(stage="later"):
            pass


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


def _run_world(world: int, out: Path, cases: str = "solve") -> list:
    """Run one spawned world; (npz, json) per rank.  The launcher and its
    ranks share a session of their own, so a timeout kills them all."""
    out.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_sharded_world.py"),
         str(world), str(out), "cpu", cases], stdout=subprocess.PIPE,
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


def test_one_rank_failures_inside_a_build_are_agreed(tmp_path):
    """Two gloo ranks whose collectives time out (so that ranks left in
    different collectives fail the test instead of hanging it): a measured
    tune, and a measured preconditioner pair, whose first sweep fails
    before its first allocation on rank 1 alone raise the same
    ShardedCallError on both ranks, naming rank 1,
    and the next build and solve serve on both; a memory hit whose
    schedule digest raises on rank 1 alone is agreed (both ranks build,
    neither serves its hit alone), and the next lookup hits on both."""
    ranks = _run_world(2, tmp_path / "build", "build")
    (arrs0, res0), (arrs1, res1) = ranks
    assert res0 == res1
    for k in arrs0.files:
        assert np.array_equal(arrs0[k], arrs1[k]), k
    for case in ("tune", "pair"):
        kind, failures = res0[case]
        assert kind == "ShardedCallError", res0[case]
        assert [r for r, _ in failures] == [1]
        assert "injected out-of-memory" in failures[0][1]
    L = generators.random_lower(400, avg_offdiag=2.0, seed=3, max_back=24)
    b = np.random.default_rng(0).standard_normal(400)
    assert _rel(arrs0["x_after_tune"], solve_csr_seq(L, b)) < 1e-10
    A = generators.poisson2d_spd(8, 8)
    assert np.isfinite(arrs0["pair_after"]).all()
    assert arrs0["pair_after"].shape == (A.n_rows,)
    assert res0["first_source"] == "built"
    assert res0["digest_source"] == "built"
    assert res0["hit_source"] == "memory"
    assert _rel(arrs0["x_digest"], solve_csr_seq(L, b)) < 1e-10


def test_one_rank_failing_after_its_last_sharded_call_is_agreed(tmp_path):
    """Two gloo ranks whose collectives time out: a measured tune whose
    first candidate sweep fails on rank 1 alone after the sweep's last
    sharded call (no collective of the sweep is left to carry it) raises
    the same ShardedCallError on both ranks, naming rank 1, and the next
    build and solve serve on both."""
    ranks = _run_world(2, tmp_path / "after", "after")
    (arrs0, res0), (arrs1, res1) = ranks
    assert res0 == res1
    kind, failures = res0["tune"]
    assert kind == "ShardedCallError", res0["tune"]
    assert [r for r, _ in failures] == [1]
    assert "after the sweep's last sharded call" in failures[0][1]
    assert np.array_equal(arrs0["x_after_tune"], arrs1["x_after_tune"])
    L = generators.random_lower(400, avg_offdiag=2.0, seed=3, max_back=24)
    b = np.random.default_rng(0).standard_normal(400)
    assert _rel(arrs0["x_after_tune"], solve_csr_seq(L, b)) < 1e-10


def test_sharded_service_world(tmp_path):
    """Two gloo ranks: a call that fails on the last rank alone (its input
    check, a step's local work, a step's scatter, through the operator)
    raises the same ShardedCallError on both, naming that rank, and the
    next call serves; the service under the mesh, rank 0 serving and rank
    1 following, forms the single-device service's batches in pump mode
    with answers within 1e-5 of its answers, every rank's answers bitwise
    equal; a hot swap at the same point of both ranks' order; a batch
    failed on rank 1 resolves all its futures with the agreed error and
    the next batch is served; an admission, a re-bind and a tune that
    fail on rank 1 alone fail alike on rank 0 and leave both ranks alike;
    auto mode with submitter threads, a pattern arriving mid-traffic,
    background tunes and close() while requests linger keeps one order
    on both ranks; a service idle for twice the group's collective
    timeout then serves; close() stops the follower (the world ends
    within its timeout)."""
    from _torch_sharded_world import pump_requests
    from repro_torch import obs
    from repro_torch.serving import SolveService
    from repro_torch.serving.server import step_values
    (a0, r0), (a1, r1) = _run_world(2, tmp_path / "serve", "serve")
    for key in ("input_check", "step", "publish", "operator"):
        assert r0[key] == r1[key], key
        assert r0[key][0] == "ShardedCallError"
        assert [r for r, _ in r0[key][1]] == [1], key
    assert "its input check: ValueError" in r0["input_check"][1][0][1]
    assert r0["step"][1][0][1].startswith("step 3: RuntimeError")
    assert r0["publish"][1][0][1].startswith("step 3: RuntimeError")
    assert "(publish)" in r0["publish"][1][0][1]
    assert r0["operator"][1][0][1].startswith("step 2: RuntimeError")
    assert r0["columns"] == r1["columns"]
    assert [r for r, _ in r0["columns"][1]] == [0, 1]
    assert r0["memoized"] and r0["operator_fallback"] == ""
    L = generators.random_lower(400, avg_offdiag=2.0, seed=3, max_back=24)
    b = np.random.default_rng(0).standard_normal(400)
    for a in (a0, a1):
        assert _rel(a["x_after_input"], solve_csr_seq(L, b)) < ORACLE_RTOL
        assert np.array_equal(a["x_after_step"], a["x_after_input"])
        assert np.array_equal(a["x_after_publish"], a["x_after_input"])
        assert _rel(a["x_operator_after"], solve_csr_seq(L, b)) < 1e-10
    assert np.array_equal(a0["x_operator_after"], a1["x_operator_after"])

    # pump mode against the single-device service
    requests = pump_requests(generators, step_values)
    kw = dict(max_width=4, max_linger_s=60.0, auto_dispatch=False,
              tune_mode="off", cache=False)
    tr = obs.enable()
    with SolveService(device="cpu", **kw) as svc:
        futs = [svc.submit(b_, M, **k) for M, b_, k in requests]
        svc.pump()
        xs1 = [f.result(timeout=0) for f in futs]
    obs.disable()
    assert r0["pump_batches"] == _serving_batches(tr)
    assert r0["pump_errors"] == [] and r1["pump_batches"] == []
    xs = [a0[f"pump_{i}"] for i in range(len(requests))]
    for x, x1 in zip(xs, xs1, strict=True):
        assert _rel(x, x1) <= REF_RTOL
    # the follower ran rank 0's commands, in rank 0's order; its batch
    # solutions hold every answer of rank 0, bitwise
    assert r0["pump_log"] == r1["pump_log"]
    cols = [a1[f"pump_{j}"] for j in range(5)]
    cols = [c[:, k] if c.ndim == 2 else c for c in cols
            for k in range(c.shape[1] if c.ndim == 2 else 1)]
    for x in xs:
        assert any(np.array_equal(x, c) for c in cols)
    assert r1["pump_snapshot"]["mesh"]["role"] == "follower"
    assert r0["pump_snapshot"]["mesh"]["size"] == 2
    for k in ("batches", "completed", "width_hist"):
        assert r0["pump_snapshot"][k] == r1["pump_snapshot"][k], k

    # the hot swap: one command, at the same point of both ranks' order
    assert r0["swap_log"] == r1["swap_log"]
    assert [k for k, _ in r0["swap_log"]] == ["admit", "batch", "tune",
                                              "batch", "close"]
    assert r0["swap_registry"] == r1["swap_registry"] == \
        {"hot_swaps": 1, "admissions": 1}
    assert r0["swap_strategies"] == r1["swap_strategies"]
    for i in range(6):
        x1 = a1[f"swap_{i // 3}"][:, i % 3]
        assert np.array_equal(a0[f"swap_{i}"], x1), i

    # the failed batch and the next one
    assert r0["fail_answers"] == [False, False, False, True]
    assert len(r0["fail_errors"]) == 3
    for err in r0["fail_errors"]:
        assert err[0] == "ShardedCallError"
        assert [r for r, _ in err[1]] == [1]
        assert err[1][0][1].startswith("step 1: RuntimeError")
    assert r1["fail_answers"] == [True]     # the follower's served batch
    assert r1["fail_mesh"]["failed_commands"] == {"batch": 1}
    assert r1["fail_mesh"]["last_error"].startswith("ShardedCallError")
    assert r0["fail_snapshot"] == r1["fail_snapshot"] == {
        "batches": 2, "batch_errors": 1, "failed": 3, "completed": 1}

    # an admission failed on rank 1: the submit raised, no entry is left
    A = generators.lung2_like(0.02)
    A1 = step_values(A, 1)
    assert r0["admit_failed"][0] == "ShardedCallError"
    assert r0["admit_failed"][1][0][0] == 1
    assert r0["admit_failed"][1][0][1].startswith("its admission: "
                                                  "MemoryError")
    assert r0["entries_after_admit_failed"] == 0
    # a re-bind failed on rank 1: both futures of its batch carry it, the
    # next batch re-binds on both ranks and serves
    assert r0["rebind_answers"] == [True, False, False, True]
    assert r1["rebind_answers"] == [True, True]
    assert len(r0["rebind_errors"]) == 2
    for err in r0["rebind_errors"]:
        assert err[0] == "ShardedCallError" and err[1][0][0] == 1
        assert err[1][0][1].startswith("its re-bind: MemoryError")
    assert r0["rebind_log"] == r1["rebind_log"]
    assert [k for k, _ in r0["rebind_log"]] == ["admit", "admit", "batch",
                                                "batch", "batch", "close"]
    assert r0["rebind_snapshot"] == r1["rebind_snapshot"] == {
        "batches": 3, "batch_errors": 1, "failed": 2, "completed": 2}
    assert r0["rebind_entries"] == r1["rebind_entries"] == 1
    wave_b = [np.random.default_rng(20 + i).standard_normal(A.n_rows)
              for i in range(3)]
    assert _rel(a0["rebind_0"], solve_csr_seq(A, wave_b[0])) < ORACLE_RTOL
    assert _rel(a0["rebind_3"], solve_csr_seq(A1, wave_b[2])) < ORACLE_RTOL
    assert np.array_equal(a0["rebind_0"], a1["rebind_0"])
    assert np.array_equal(a0["rebind_3"], a1["rebind_1"])
    # a tune failed on rank 1: degraded on both, no swap, the same answers
    assert r0["tune_fail_log"] == r1["tune_fail_log"]
    assert [k for k, _ in r0["tune_fail_log"]] == ["admit", "batch", "tune",
                                                   "batch", "close"]
    assert r0["tune_fail_registry"] == r1["tune_fail_registry"] == \
        {"hot_swaps": 0, "tuner_failures": 1}
    assert r0["tune_fail_states"] == r1["tune_fail_states"] == ["degraded"]
    assert r0["tune_fail_errors"] == []
    for i in range(6):
        assert np.array_equal(a0[f"tune_fail_{i}"],
                              a1[f"tune_fail_{i // 3}"][:, i % 3]), i

    # auto mode: one order on both ranks, every answer on the oracle and
    # bitwise among the follower's batch columns
    auto = r0["auto"]
    assert auto["log"] == r1["auto"]["log"]
    kinds = [k for k, _ in auto["log"]]
    assert kinds.count("admit") == 2 and kinds.count("tune") == 2
    assert kinds[-1] == "close" and auto["warm"]
    assert auto["snapshot"] == {"submitted": 22, "completed": 22,
                                "failed": 0}
    assert auto["hot_swaps"] == 2
    B_ = generators.torso2_like(0.02)
    mats = [A] * 12 + [A, B_] * 4 + [A, B_]
    cols = []
    for key in a1.files:
        if key.startswith("auto_batch_"):
            c = a1[key]
            cols += [c[:, k] for k in range(c.shape[1])] if c.ndim == 2 \
                else [c]
    for i, M in enumerate(mats):
        x = a0[f"auto_{i}"]
        b_ = np.random.default_rng(60 + i).standard_normal(M.n_rows)
        assert _rel(x, solve_csr_seq(M, b_)) < ORACLE_RTOL, i
        assert any(np.array_equal(x, c) for c in cols), i

    # idle for twice the collective timeout, then served
    x0 = np.load(tmp_path / "serve" / "idle0.npz")["arr_0"]
    x1 = np.load(tmp_path / "serve" / "idle1.npz")["arr_0"]
    b_ = np.random.default_rng(40).standard_normal(A.n_rows)
    assert _rel(x0, solve_csr_seq(A, b_)) < ORACLE_RTOL
    assert np.array_equal(x0, x1)
    # a registry given with max_entries=1 on both ranks: rank 0 evicts by
    # its LRU order and sends the eviction; the follower's cap is lifted
    assert r0["evict_log"] == r1["evict_log"]
    assert [k for k, _ in r0["evict_log"]] == ["admit", "batch", "admit",
                                               "evict", "batch", "close"]
    assert r0["evict_entries"] == r1["evict_entries"] and \
        len(r0["evict_entries"]) == 1
    assert r0["evict_max_entries"] == 1 and r1["evict_max_entries"] is None
    assert r0["closed"] and r1["closed"]


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

def _swapped_first_and_last_tile(packed):
    """`packed` with its first and last tiles swapped: a step order the
    packed-form certifier refuses."""
    import dataclasses
    w = packed.tiles.numpy()
    tp = 4 * packed.tile_ptr.numpy().astype(np.int64)
    tiles = [w[a:b].copy() for a, b in zip(tp[:-1], tp[1:])]
    tiles[0], tiles[-1] = tiles[-1], tiles[0]
    ptr = np.concatenate([[0], np.cumsum([t.size // 4 for t in tiles])])
    return dataclasses.replace(
        packed, tiles=torch.from_numpy(np.concatenate(tiles)),
        tile_ptr=torch.from_numpy(ptr.astype(np.int32)))


def _defective_packs(monkeypatch):
    real = K.pack_schedule
    monkeypatch.setattr(K, "pack_schedule",
                        lambda s: _swapped_first_and_last_tile(real(s)))


def test_strict_lost_mesh_certifies_the_fallback_tiles(world1, monkeypatch):
    """Strict health on a sharded operator whose mesh is lost: the build
    certifies the schedule and packs nothing; the kernel's packed forms,
    main and preamble, are packed and certified at their first use,
    before they are handed out (on a card the "sharded->cuda" fallback's
    first K1 launch; here the forms asked for directly, since the CPU
    fallback runs the plain body, which reads none), and a defective
    pack raises ScheduleInvariantError there."""
    from repro_torch.core.resilience import ScheduleInvariantError
    L = generators.lung2_like(0.05)
    b = np.random.default_rng(4).standard_normal(L.n_rows)

    def strict_lost():
        with faults.lose_mesh():
            return TriangularOperator.from_csr(
                L, "avgLevelCost", mesh=world1, cache=False,
                health="strict")

    op = strict_lost()
    assert op.certificate is not None
    assert "packed" not in op._payload
    assert "packed_certificate" not in op._payload
    assert _rel(op.solve(b), solve_csr_seq(L, b)) < 1e-10
    assert op.stats.last_fallback == "sharded->torch"
    assert "packed" not in op._payload          # the plain body packs none
    packed = op._packed("packed")
    op._packed("preamble_packed")
    certs = op._payload["packed_certificate"]
    assert certs["packed"].lanes == L.n_rows == packed.num_lanes
    assert certs["preamble_packed"] is not None
    op._packed("packed")
    assert op._payload["packed_certificate"]["packed"] is certs["packed"]
    _defective_packs(monkeypatch)
    bad = strict_lost()
    with pytest.raises(ScheduleInvariantError):
        bad._packed("packed")
    assert "packed_certificate" not in bad._payload
    # without strict health nothing is certified at that use
    lax = TriangularOperator.from_csr(L, "avgLevelCost", mesh=world1,
                                      cache=False)
    lax._packed("packed")
    assert "packed_certificate" not in lax._payload


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
def test_cuda_strict_lost_mesh_certifies_k1_tiles_before_launch(
        nccl_world1, monkeypatch):
    """On the card: a strict sharded operator whose mesh is lost is served
    by K1 ("sharded->cuda") only after K1's packed tiles are certified; a
    defective pack fails the chain with no K1 launch."""
    from repro_torch.core.resilience import EngineFallbackError
    L = generators.lung2_like(0.05)
    b = np.random.default_rng(4).standard_normal(L.n_rows)

    def strict_lost():
        with faults.lose_mesh():
            return TriangularOperator.from_csr(
                L, "avgLevelCost", mesh=nccl_world1, cache=False,
                health="strict")

    op = strict_lost()
    assert "packed_certificate" not in op._payload
    before = K.LAUNCHES["sptrsv_groups"]
    with pytest.warns(Warning):
        x = op.solve(b)
    assert op.stats.last_fallback == "sharded->cuda"
    assert K.LAUNCHES["sptrsv_groups"] > before
    assert set(op._payload["packed_certificate"]) == {"packed",
                                                      "preamble_packed"}
    assert _rel(x, solve_csr_seq(L, b)) < 1e-10
    _defective_packs(monkeypatch)
    bad = strict_lost()
    before = dict(K.LAUNCHES)
    with pytest.raises(EngineFallbackError, match="ScheduleInvariantError"):
        bad.solve(b)
    assert dict(K.LAUNCHES) == before


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
