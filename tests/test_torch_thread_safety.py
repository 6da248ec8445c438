"""The port's shared state under a thread pool, on the CPU.

The solve service launches kernels from its worker threads, its
dispatcher and its tuner thread at once.  These tests hammer, with more
threads than cores and a shortened switch interval, what those threads
share: the kernels' launch and pack counts (exact totals, which a lost
`+=` would break), an operator's stats record, the metrics registry, the
ctypes entry points (bound once), and the service's own counters.  They
are the port's counterparts of tests/test_thread_safety.py.
"""
import concurrent.futures
import ctypes
import sys
import threading
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import spmv_ell as K4
from repro_torch.kernels import sptrsv_level as K
from repro_torch.kernels.ops import ell_pack_csr
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serving import SolveService
from repro_torch.solver import TriangularOperator
from repro_torch.solver.levelset import pad_rhs, to_device
from repro_torch.solver.operator import OperatorStats
from repro_torch.solver.reference import solve_csr_seq
from repro_torch.solver.schedule import schedule_for_csr
from repro_torch.sparse import build_levels, generators

torch.set_num_threads(1)

THREADS = 16
WAIT_S = 120


@pytest.fixture(autouse=True)
def _fresh(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "cache"))
    TriangularOperator.clear_memory_cache()
    yield
    TriangularOperator.clear_memory_cache()


@pytest.fixture
def fast_switching():
    """Switch threads every microsecond, restored afterwards."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


def _hammer(worker, threads=THREADS):
    barrier = threading.Barrier(threads)

    def run(tid):
        barrier.wait(timeout=WAIT_S)
        worker(tid)

    with concurrent.futures.ThreadPoolExecutor(max_workers=threads) as pool:
        futs = [pool.submit(run, t) for t in range(threads)]
        for f in futs:
            f.result(timeout=WAIT_S)


def test_launch_and_pack_counts_exact_under_thread_pool(fast_switching):
    """K1's, K2's and K4's plain paths and the packer, called from 16
    threads at once: every launch and pack is counted exactly once."""
    L = generators.random_lower(80, avg_offdiag=2.5, seed=0)
    ds = to_device(schedule_for_csr(L, build_levels(L), chunk=16,
                                    max_deps=4), "cpu")
    n, nc = L.n_rows, ds.n_carry
    c1 = pad_rhs(torch.ones(n, dtype=torch.float32))
    c2 = pad_rhs(torch.ones((n, 4), dtype=torch.float32))
    A = generators.random_spd(60, avg_offdiag=2.0, seed=1)
    idx, coef, _ = (torch.as_tensor(a) for a in ell_pack_csr(A))
    x_pad = torch.ones(A.n_rows + 1, dtype=torch.float32)
    leaves = tuple((g.row_ids, g.dep_idx, g.dep_coef, g.dinv) +
                   ((g.carry_in, g.carry_out) if g.carry_in is not None
                    else ()) for g in ds.host.groups)
    reps = 20
    launches, packs = dict(K.LAUNCHES), dict(K.PACKS)
    spmv = dict(K4.LAUNCHES)

    def worker(_tid):
        for _ in range(reps):
            K.sptrsv_groups(ds.groups, c1, n=n, n_carry=nc)
            K.sptrsv_groups_multi(ds.groups, c2, n=n, n_carry=nc)
            K4.spmv_ell(idx, coef, x_pad)
            K.pack_groups(leaves, n, nc)

    _hammer(worker)
    total = THREADS * reps
    assert K.LAUNCHES["plain"] == launches["plain"] + 2 * total
    assert K.PACKS["pack_groups"] == packs["pack_groups"] + total
    assert K4.LAUNCHES["plain"] == spmv["plain"] + total
    assert dict(K.LAUNCHES, plain=0) == dict(launches, plain=0)


def test_counts_reset_and_read_as_a_dict():
    K.reset_launch_counts()
    assert dict(K.LAUNCHES) == dict.fromkeys(K.LAUNCHES, 0)
    K.LAUNCHES.add("plain", 3)
    saved = dict(K.LAUNCHES)
    K.LAUNCHES.add("plain")
    K.LAUNCHES.update(saved)
    assert K.LAUNCHES["plain"] == 3 and isinstance(K.LAUNCHES, dict)
    K4.reset_launch_counts()
    assert K4.LAUNCHES == {"spmv_ell": 0, "plain": 0}


def test_entry_points_are_bound_once(monkeypatch):
    """Threads asking for a library's entry points at once get the same
    functions, loaded once, their argtypes set once."""
    loads = []

    def fake_load(name):
        loads.append(name)
        return types.SimpleNamespace(
            f_launch=types.SimpleNamespace(), g_launch=types.SimpleNamespace())

    monkeypatch.setattr(build, "load_library", fake_load)
    monkeypatch.setattr(build, "_BOUND", {})
    sig = {"f_launch": [ctypes.c_void_p, ctypes.c_int],
           "g_launch": [ctypes.c_int]}
    got = []
    _hammer(lambda _t: got.append(build.entry_points("fake", sig)), 8)
    assert loads == ["fake"]
    assert all(g is got[0] for g in got)
    assert got[0]["f_launch"].argtypes == sig["f_launch"]
    assert got[0]["g_launch"].restype is ctypes.c_int


def test_operator_stats_counters_exact_under_thread_pool(fast_switching):
    """T x K concurrent solves on ONE operator: every counter lands
    exactly."""
    L = generators.random_lower(120, avg_offdiag=2.5, seed=0)
    op = TriangularOperator.from_csr(L, tune="no_rewriting", device="cpu",
                                     cache=False)
    b = np.ones(L.n_rows)
    op.solve(b, max_refine=0)
    base = op.stats.to_dict()
    reps = 10

    def worker(_tid):
        for _ in range(reps):
            op.solve(b, max_refine=0)

    _hammer(worker, 8)
    snap = op.stats.to_dict()
    assert snap["solves"] - base["solves"] == 8 * reps
    assert snap["rhs_columns"] - base["rhs_columns"] == 8 * reps
    assert snap["total_solve_ms"] > base["total_solve_ms"]


def test_stats_record_methods_are_atomic_without_solves(fast_switching):
    stats = OperatorStats()
    reps = 200

    def worker(_tid):
        for _ in range(reps):
            stats.record_solve(ms=0.5, columns=2, rounds=1, residual=1e-12)
            stats.record_value_update(ms=0.1, cache_source="pattern",
                                      repacks=1)
            stats.record_health_event("output:raised")

    _hammer(worker)
    total = THREADS * reps
    assert stats.solves == total and stats.rhs_columns == 2 * total
    assert stats.refine_rounds == total
    assert stats.total_solve_ms == pytest.approx(0.5 * total)
    assert stats.value_updates == total and stats.repacks == total
    assert stats.health_events == total
    assert stats.to_dict()["solves"] == total


def test_metrics_registry_hammer_exact_totals(fast_switching):
    reg = MetricsRegistry(prefix="hammer")
    c = reg.counter("ops", "ops")
    g = reg.gauge("level", "level")
    h = reg.histogram("lat_ms", "latency", reservoir=200_000)
    reps = 500

    def worker(tid):
        for i in range(reps):
            c.inc()
            c.inc(2, route=f"r{tid % 4}")
            g.add(1.0)
            h.observe(float(i % 7))
            with reg.lock:
                c.inc(route="atomic")
                h.observe(100.0)

    _hammer(worker)
    total = THREADS * reps
    assert c.value() == total and c.value(route="atomic") == total
    for r in range(4):
        assert c.value(route=f"r{r}") == 2 * reps * (THREADS // 4)
    assert c.total() == 4 * total
    assert g.value() == float(total)
    assert h.count() == 2 * total and len(h.samples()) == 2 * total
    assert h.sum() == pytest.approx(
        total * 100.0 + THREADS * sum(i % 7 for i in range(reps)))
    assert reg.snapshot()["ops"]["series"][""] == total


def test_service_counts_exact_under_concurrent_submitters(fast_switching):
    """Eight tenants submit at once to an auto-dispatching service: every
    request completes with the oracle's answer, and the counters add up."""
    mats = [generators.random_lower(90, avg_offdiag=2.5, seed=10 + i)
            for i in range(3)]
    refs = [solve_csr_seq(M, np.ones(M.n_rows)) for M in mats]
    reps = 6
    errors = []
    with SolveService(max_width=4, max_linger_s=0.001, workers=3,
                      tenant_cap=None, tune_mode="off", device="cpu",
                      cache=False) as svc:
        def worker(tid):
            futs = [(i, svc.submit(np.ones(mats[i].n_rows), mats[i],
                                   tenant=f"t{tid}"))
                    for i in (np.arange(reps) + tid) % len(mats)]
            for i, f in futs:
                err = np.abs(f.result(timeout=WAIT_S) - refs[i]).max()
                if err > 5e-5 * max(1.0, np.abs(refs[i]).max()):
                    errors.append((tid, i, err))

        _hammer(worker, 8)
    snap = svc.snapshot()
    assert errors == []
    assert snap["submitted"] == snap["completed"] == 8 * reps
    assert sum(w * c for w, c in snap["width_hist"].items()) == 8 * reps
    assert sum(snap["width_hist"].values()) == snap["batches"]
    assert svc.inflight() == 0
