"""The port's solve service against the reference's, on the CPU.

* Pump mode (`auto_dispatch=False`, no threads) is deterministic, so the
  same requests through both packages' services must form the same
  batches (widths, flush reasons, order, padding); their answers agree
  within 1e-5 relative to max|x| (float32 sweeps summing rows in another
  order), and both lie within 5e-5 of the float64 `solve_csr_seq` (the
  reference's own serving bound, tests/test_serving.py).  The two
  `ServiceStats.snapshot()`s have the same keys and counts.
* The reference's service suite (tests/test_serving.py), ported: tenancy,
  value fingerprints, the cold -> warming -> hot life cycle, the hot swap
  that keeps the latest values, eviction, orientation, the mixed workload,
  and the tuner faults (a failing or slow `StrategyPortfolio.tune`,
  patched with monkeypatch).  A batch whose solve raises resolves every
  future with that exception: nothing answers in its place.
* A value re-bind whose rewrite fill underflows to 0 keeps the tuned
  operator: the port's replay keeps those zeros explicit, where the
  reference's raises.
* A hot swap whose re-bind of the tuned operator to the latest values
  raises takes the tuner-failure path (the entry degraded, the error kept,
  a tuner failure counted, a warning), where the reference's tune job
  raises and leaves the entry warming.
Every wait is bounded.  The `cuda` cases serve on the card and skip here;
the JAX package is imported only inside the tests that compare with it,
so that they run on a card without JAX.
"""
import json
import time
import types
import warnings

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core.portfolio import StrategyPortfolio
from repro_torch.core.resilience import AdmissionError, TunerFailureWarning
from repro_torch.core.strategies import CriticalPathRewrite, ManualEveryK
from repro_torch.kernels import sptrsv_level as K
from repro_torch.serving import EntryKey, OperatorRegistry, SolveService
from repro_torch.serving import server
from repro_torch.serving.server import run_workload, step_values
from repro_torch.solver import TriangularOperator
from repro_torch.solver.operator import matrix_fingerprint
from repro_torch.solver.reference import solve_csr_seq
from repro_torch.sparse import generators

torch.set_num_threads(1)

WAIT_S = 120            # every future and tune wait is bounded by this
PARITY_RTOL = 1e-5      # port vs reference, relative to max|x|
ORACLE_RTOL = 5e-5      # float32 serving vs the float64 oracle
CPU = {"device": "cpu", "cache": False}


@pytest.fixture(autouse=True)
def _fresh(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "cache"))
    obs.disable()
    TriangularOperator.clear_memory_cache()
    yield
    obs.disable()
    TriangularOperator.clear_memory_cache()


@pytest.fixture
def ref():
    """The reference's serving tier, tracer and generators, with its
    tracing off and its operator cache empty around the test."""
    from repro import obs as ref_obs
    from repro.serving import SolveService as RefService
    from repro.serving.server import step_values as ref_step_values
    from repro.solver import TriangularOperator as RefOperator
    from repro.sparse import generators as ref_gen
    ref_obs.disable()
    RefOperator.clear_memory_cache()
    yield types.SimpleNamespace(obs=ref_obs, Service=RefService,
                                gen=ref_gen, step_values=ref_step_values)
    ref_obs.disable()
    RefOperator.clear_memory_cache()


@pytest.fixture(scope="module")
def L():
    return generators.lung2_like(scale=0.02)


@pytest.fixture(scope="module")
def L2():
    return generators.torso2_like(scale=0.02)


def _rhs(L, seed=0):
    return np.random.default_rng(seed).standard_normal(L.n_rows)


def _oracle_err(x, L, b):
    ref = solve_csr_seq(L, np.asarray(b, dtype=np.float64))
    err = np.max(np.abs(np.asarray(x, dtype=np.float64) - ref))
    return err / max(1.0, np.max(np.abs(ref)))


# -- pump mode against the reference ------------------------------------------

def _pump_script(svc, gen, step):
    """Eleven requests over two patterns, a value step and a transposed
    sweep, pumped once: returns (answers, the matrices and b's)."""
    A, B = gen.lung2_like(0.02), gen.torso2_like(0.02)
    A1 = step(A, 1)
    reqs = [(A, 0, {}), (B, 1, {}), (A, 2, {}), (A, 3, {}), (A1, 4, {}),
            (A, 5, {}), (A, 6, {}), (A, 7, {}), (A1, 8, {}),
            (A, 9, {"transpose": True}), (B, 10, {})]
    futs, used = [], []
    for M, seed, kw in reqs:
        b = _rhs(M, seed)
        futs.append(svc.submit(b, M, **kw))
        used.append((M, b, kw))
    assert svc.pump() == 5
    return [f.result(timeout=0) for f in futs], used


def _batches(tracer):
    return [{k: v for k, v in s.attrs.items() if k != "pattern"}
            for s in tracer.spans() if s.name == "serving.batch"]


def test_pump_mode_forms_the_reference_batches_and_answers(ref):
    kw = dict(max_width=4, max_linger_s=60.0, auto_dispatch=False,
              tune_mode="off", cache=False)
    tr = obs.enable()
    with SolveService(device="cpu", **kw) as svc:
        xs, used = _pump_script(svc, generators, step_values)
        snap = svc.snapshot()
    obs.disable()
    ref_tr = ref.obs.enable()
    with ref.Service(**kw) as ref_svc:
        ref_xs, _ = _pump_script(ref_svc, ref.gen, ref.step_values)
        ref_snap = ref_svc.snapshot()
    ref.obs.disable()
    got, want = _batches(tr), _batches(ref_tr)
    for b in got + want:
        b.pop("solve_ms")
    assert got == want
    assert [(b["width"], b["reason"]) for b in got] == \
        [(4, "width"), (2, "drain"), (2, "drain"), (2, "drain"), (1, "drain")]
    assert {b.get("padded_width") for b in got} == {None}
    for x, x_ref, (M, b, kw_) in zip(xs, ref_xs, used):
        scale = max(1.0, float(np.abs(x_ref).max()))
        assert float(np.abs(np.asarray(x, np.float64) - x_ref).max()) \
            <= PARITY_RTOL * scale
        if not kw_:
            assert _oracle_err(x, M, b) <= ORACLE_RTOL
            assert _oracle_err(x_ref, M, b) <= ORACLE_RTOL
    # the snapshots: the same keys, the same counts
    assert set(snap) == set(ref_snap)
    assert set(snap["registry"]) == set(ref_snap["registry"])
    for k in ("submitted", "completed", "rejected", "failed", "batches",
              "batch_errors", "width_hist", "flush_reasons",
              "cache_sources", "rejected_by_tenant", "mean_width"):
        assert snap[k] == ref_snap[k], k
    for k in ("admissions", "evictions", "tuner_failures", "hot_swaps",
              "value_rebinds", "states"):
        assert snap["registry"][k] == ref_snap["registry"][k], k
    assert set(snap["queue_ms"]) == set(ref_snap["queue_ms"])


def test_padded_batches_match_the_reference(ref):
    """Three requests pad to a width-4 solve in both packages."""
    kw = dict(max_width=8, max_linger_s=60.0, auto_dispatch=False,
              tune_mode="off", cache=False)
    out = {}
    for name, Svc, gen, o in (("port", SolveService, generators, obs),
                              ("ref", ref.Service, ref.gen, ref.obs)):
        M = gen.torso2_like(0.02)
        tr = o.enable()
        extra = {"device": "cpu"} if name == "port" else {}
        with Svc(**kw, **extra) as svc:
            futs = [svc.submit(_rhs(M, s), M) for s in range(3)]
            svc.pump()
            out[name] = ([f.result(timeout=0) for f in futs],
                         _batches(tr))
        o.disable()
    (xs, got), (ref_xs, want) = out["port"], out["ref"]
    for b in got + want:
        b.pop("solve_ms")
    assert got == want == [{"width": 3, "reason": "drain",
                            "padded_width": 4}]
    for x, x_ref in zip(xs, ref_xs):
        assert np.abs(np.asarray(x, np.float64) - x_ref).max() <= \
            PARITY_RTOL * max(1.0, float(np.abs(x_ref).max()))


# -- the reference's service suite, ported ------------------------------------

def test_pump_mode_is_bitwise_faithful_to_direct_batched_solve(L):
    b_cols = [_rhs(L, s) for s in range(3)]
    with SolveService(max_width=8, max_linger_s=60.0, auto_dispatch=False,
                      pad_widths=False, tune_mode="off", **CPU) as svc:
        futs = [svc.submit(b, L) for b in b_cols]
        assert not any(f.done() for f in futs)
        assert svc.pump() == 1
        xs = [f.result(timeout=0) for f in futs]
        snap = svc.snapshot()
    op = TriangularOperator.from_csr(L, tune="no_rewriting", **CPU)
    X = np.asarray(op.solve(np.stack(b_cols, axis=1), max_refine=0))
    for j, x in enumerate(xs):
        np.testing.assert_array_equal(np.asarray(x), X[:, j])
    assert snap["width_hist"] == {3: 1} and snap["flush_reasons"] == \
        {"drain": 1}
    assert snap["submitted"] == snap["completed"] == 3


def test_value_fingerprints_never_share_a_batch(L):
    L_new = step_values(L, 3)
    b = _rhs(L)
    with SolveService(max_width=8, max_linger_s=60.0, auto_dispatch=False,
                      tune_mode="off", **CPU) as svc:
        f_old, f_new = svc.submit(b, L), svc.submit(b, L_new)
        assert svc.pump() == 2
        x_old, x_new = f_old.result(0), f_new.result(0)
        reg = svc.registry.stats()
    for x, mat in ((x_old, L), (x_new, L_new)):
        assert _oracle_err(x, mat, b) < ORACLE_RTOL
    assert reg["admissions"] == 1
    assert next(iter(reg["entries"].values()))["op"]["value_updates"] >= 1


def test_failing_batch_resolves_every_future_with_its_error(L, monkeypatch):
    """A solve that raises inside a served batch (an unknown engine, then
    an injected failure of the device solve) reaches every future of the
    batch as that exception; no other engine answers, and the service
    keeps serving."""
    b = _rhs(L)
    with SolveService(max_width=8, max_linger_s=60.0, auto_dispatch=False,
                      tune_mode="off", **CPU,
                      solve_kwargs={"max_refine": 0,
                                    "engine": "bogus"}) as svc:
        futs = [svc.submit(b, L) for _ in range(2)]
        svc.pump()
        for f in futs:
            with pytest.raises(ValueError, match="unknown engine"):
                f.result(0)
        assert svc.snapshot()["failed"] == 2
        svc.solve_kwargs = {"max_refine": 0}

        def broken(self, c, engine):
            raise RuntimeError("injected kernel failure")

        with monkeypatch.context() as m:
            m.setattr(TriangularOperator, "_device_solve", broken)
            futs = [svc.submit(_rhs(L, s), L) for s in range(3)]
            svc.pump()
            for f in futs:
                with pytest.raises(RuntimeError, match="injected kernel"):
                    f.result(0)
        f = svc.submit(b, L)
        svc.pump()
        assert _oracle_err(f.result(0), L, b) < ORACLE_RTOL
        snap = svc.snapshot()
    assert snap["failed"] == 5 and snap["completed"] == 1
    assert snap["batch_errors"] == 2


def test_wrong_shape_rhs_rejected_at_submit(L):
    with SolveService(auto_dispatch=False, tune_mode="off", **CPU) as svc:
        with pytest.raises(ValueError, match="b must be"):
            svc.submit(np.zeros(L.n_rows + 1), L)
        assert svc.inflight() == 0


def test_tenant_cap_rejects_with_typed_error_and_spares_others(L):
    b = _rhs(L)
    with SolveService(max_width=64, max_linger_s=60.0, auto_dispatch=False,
                      tenant_cap=2, tune_mode="off", **CPU) as svc:
        svc.submit(b, L, tenant="alice")
        svc.submit(b, L, tenant="alice")
        with pytest.raises(AdmissionError) as ei:
            svc.submit(b, L, tenant="alice")
        assert (ei.value.tenant, ei.value.depth, ei.value.limit) == \
            ("alice", 2, 2)
        f = svc.submit(b, L, tenant="bob")
        svc.pump()
        f.result(0)
        snap = svc.snapshot()
    assert snap["rejected"] == 1 and snap["rejected_by_tenant"] == \
        {"alice": 1}
    assert snap["completed"] == 3


def test_completed_requests_release_tenant_slots(L):
    b = _rhs(L)
    with SolveService(max_width=64, max_linger_s=60.0, auto_dispatch=False,
                      tenant_cap=1, tune_mode="off", **CPU) as svc:
        svc.submit(b, L, tenant="t")
        svc.pump()
        svc.submit(b, L, tenant="t")
        svc.pump()
        assert svc.snapshot()["completed"] == 2


def test_cold_warming_hot_lifecycle_and_atomic_swap(L):
    b = _rhs(L)
    with SolveService(max_width=4, max_linger_s=0.001, workers=2,
                      tune_mode="background", **CPU) as svc:
        xs = [svc.submit(b, L).result(WAIT_S) for _ in range(3)]
        assert svc.wait_warm(timeout=WAIT_S)
        xs.append(svc.submit(b, L).result(WAIT_S))
        reg = svc.registry.stats()
    assert reg["hot_swaps"] == 1 and dict(reg["states"]) == {"hot": 1}
    assert next(iter(reg["entries"].values()))["tune_error"] == ""
    for x in xs:
        assert _oracle_err(x, L, b) < ORACLE_RTOL


def _slow_tune(monkeypatch, delay_s):
    """StrategyPortfolio.tune stalled by `delay_s`; returns its call count."""
    count = {"calls": 0}
    tune = StrategyPortfolio.tune

    def slow(self, M):
        count["calls"] += 1
        time.sleep(delay_s)
        return tune(self, M)

    monkeypatch.setattr(StrategyPortfolio, "tune", slow)
    return count


def test_hot_swap_keeps_latest_values_when_updates_race_the_tune(
        L, monkeypatch):
    b = _rhs(L)
    L_new = step_values(L, 5)
    count = _slow_tune(monkeypatch, 0.4)
    # one cheap candidate, so that the tuned pick re-binds exactly
    with SolveService(max_width=4, max_linger_s=0.001, workers=2,
                      tune_mode="background", **CPU,
                      portfolio=StrategyPortfolio(
                          candidates=[ManualEveryK(k=10)],
                          device="cpu")) as svc:
        svc.submit(b, L).result(WAIT_S)
        assert svc.registry.stats()["states"].get("warming") == 1
        x_new = svc.submit(b, L_new).result(WAIT_S)
        assert svc.wait_warm(timeout=WAIT_S)
        x_post = svc.submit(b, L_new).result(WAIT_S)
        reg = svc.registry.stats()
    assert count["calls"] == 1 and reg["hot_swaps"] == 1
    entry = next(iter(reg["entries"].values()))
    assert entry["strategy"].startswith("manual_every_k")
    for x in (x_new, x_post):
        assert _oracle_err(x, L_new, b) < ORACLE_RTOL


def test_swap_rebind_that_raises_degrades_the_entry(L, monkeypatch):
    """The tuned operator is built on the admission values, where one
    dependency is 0, so its transformation drops the fill that entry
    feeds; the values sent while the tune runs make that fill non-zero,
    outside the frozen pattern, so the swap's re-bind raises.  The entry
    ends degraded with the error, one tuner failure and a warning, and
    the untuned operator, re-bound to those values, keeps answering."""
    rows = np.repeat(np.arange(L.n_rows), L.row_nnz())
    data = L.data.copy()
    data[(rows == 50) & (L.indices == 31)] = 0.0     # row 50 is rewritten
    L0 = L.with_data(data)
    b = _rhs(L)
    count = _slow_tune(monkeypatch, 0.4)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with SolveService(max_width=4, max_linger_s=0.001, workers=2,
                          tune_mode="background", **CPU,
                          portfolio=StrategyPortfolio(
                              candidates=[ManualEveryK(k=10)],
                              device="cpu")) as svc:
            x0 = svc.submit(b, L0).result(WAIT_S)
            assert svc.registry.stats()["states"].get("warming") == 1
            x1 = svc.submit(b, L).result(WAIT_S)
            assert svc.wait_warm(timeout=WAIT_S)
            x2 = svc.submit(b, L).result(WAIT_S)
            reg = svc.registry.stats()
    assert count["calls"] == 1
    assert dict(reg["states"]) == {"degraded": 1}
    assert reg["hot_swaps"] == 0 and reg["tuner_failures"] == 1
    entry = next(iter(reg["entries"].values()))
    assert entry["tune_error"].startswith("PatternMismatchError")
    assert entry["strategy"] == "no_rewriting"
    assert any(issubclass(w.category, TunerFailureWarning) for w in caught)
    assert _oracle_err(x0, L0, b) < ORACLE_RTOL
    for x in (x1, x2):
        assert _oracle_err(x, L, b) < ORACLE_RTOL


def test_sync_mode_is_hot_immediately(L):
    reg = OperatorRegistry(tune_mode="sync", **CPU)
    try:
        entry, _, created = reg.admit(L)
        assert created and entry.state == "hot" and entry.hot_swaps == 0
        _, _, again = reg.admit(L)
        assert not again and len(reg) == 1
    finally:
        reg.close()


def test_registry_eviction_bounds_live_entries(L, L2):
    reg = OperatorRegistry(tune_mode="off", max_entries=1, **CPU)
    try:
        reg.admit(L)
        reg.admit(L2)
        assert len(reg) == 1 and reg.evictions == 1
        assert reg.get(EntryKey(pattern_fp=matrix_fingerprint(
            L2, include_values=False))) is not None
        assert reg.metrics.get("evictions").value() == 1
    finally:
        reg.close()


def test_orientation_is_part_of_the_entry_key(L):
    b = _rhs(L)
    with SolveService(max_width=8, max_linger_s=60.0, auto_dispatch=False,
                      tune_mode="off", **CPU) as svc:
        f_fwd = svc.submit(b, L)
        f_t = svc.submit(b, L, transpose=True)
        assert svc.pump() == 2
        x_fwd, x_t = f_fwd.result(0), f_t.result(0)
        assert svc.registry.stats()["admissions"] == 2
    assert not np.allclose(np.asarray(x_fwd), np.asarray(x_t))
    ref = solve_csr_seq(L.transpose().transpose(), b)   # shape sanity
    assert ref.shape == x_t.shape


def test_mixed_workload_matches_oracle_with_zero_drops(L, L2):
    """Hot solves, cold admissions and update_values traffic from three
    tenant threads, refined to 1e-8 of the oracle, nothing dropped, at
    least one hot swap, and value re-binds that survive the swap."""
    with SolveService(max_width=8, max_linger_s=0.002, workers=2,
                      tenant_cap=64, tune_mode="background", **CPU,
                      solve_kwargs={"max_refine": 6}) as svc:
        result = run_workload(svc, [L, L2], requests=24, tenants=3,
                              value_steps=2, seed=0, rel_tol=1e-8)
        assert svc.wait_warm(timeout=WAIT_S)
    assert result["errors"] == [] and result["checked"] == 24
    snap = svc.snapshot()
    assert snap["submitted"] == snap["completed"] == 24
    assert snap["rejected"] == 0 and snap["failed"] == 0
    assert snap["registry"]["hot_swaps"] >= 1
    reg = svc.registry.stats()
    assert reg["admissions"] == 2 and reg["value_rebinds"] >= 1
    assert sum(snap["width_hist"].values()) == snap["batches"]


def test_fail_tuner_degrades_entry_but_serving_continues(L, monkeypatch):
    b = _rhs(L)
    count = {"calls": 0}

    def fail(self, M):
        count["calls"] += 1
        raise RuntimeError("injected tuner failure")

    monkeypatch.setattr(StrategyPortfolio, "tune", fail)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with SolveService(max_width=4, max_linger_s=0.001, workers=2,
                          tune_mode="background", **CPU) as svc:
            x0 = svc.submit(b, L).result(WAIT_S)
            assert svc.wait_warm(timeout=WAIT_S)
            x1 = svc.submit(b, L).result(WAIT_S)
            reg = svc.registry.stats()
    assert count["calls"] == 1
    assert dict(reg["states"]) == {"degraded": 1}
    assert reg["hot_swaps"] == 0 and reg["tuner_failures"] == 1
    entry = next(iter(reg["entries"].values()))
    assert "injected tuner failure" in entry["tune_error"]
    assert entry["strategy"] == "no_rewriting"
    assert any(issubclass(w.category, TunerFailureWarning) for w in caught)
    for x in (x0, x1):
        assert _oracle_err(x, L, b) < ORACLE_RTOL


def test_slow_tuner_never_blocks_the_request_path(L, monkeypatch):
    b = _rhs(L)
    _slow_tune(monkeypatch, 0.6)
    with SolveService(max_width=4, max_linger_s=0.001, workers=2,
                      tune_mode="background", **CPU) as svc:
        xs = [svc.submit(b, L).result(WAIT_S) for _ in range(4)]
        state_during = dict(svc.registry.stats()["states"])
        assert svc.wait_warm(timeout=WAIT_S)
        reg = svc.registry.stats()
    assert state_during == {"warming": 1}
    assert reg["hot_swaps"] == 1 and dict(reg["states"]) == {"hot": 1}
    for x in xs:
        assert _oracle_err(x, L, b) < ORACLE_RTOL


# -- a re-bind whose fill underflows -------------------------------------------

def test_value_rebind_whose_fill_underflows_keeps_the_tuned_operator(L):
    """critical_path(beta=8) on lung2_like(0.03) rewrites every row; under
    step_values some of its fill underflows to zero (the reference's
    replay raises PatternMismatchError there).  The port's replay keeps
    those zeros explicit, so the re-bind goes through `update_values`: the
    entry stays hot on the tuned operator and serves the right answer."""
    M = generators.lung2_like(0.03)
    M1 = step_values(M, 1)
    b = _rhs(M)
    with SolveService(max_width=4, max_linger_s=60.0, auto_dispatch=False,
                      tune_mode="sync", tune=CriticalPathRewrite(beta=8),
                      **CPU) as svc:
        f0, f1 = svc.submit(b, M), svc.submit(b, M1)
        svc.pump()
        x0, x1 = f0.result(0), f1.result(0)
        reg = svc.registry.stats()
    entry = next(iter(reg["entries"].values()))
    assert entry["state"] == "hot" and entry["tune_error"] == ""
    assert entry["strategy"].startswith("critical_path(beta=8")
    assert entry["value_rebinds"] == reg["value_rebinds"] == 1
    assert entry["op"]["value_updates"] == 1
    assert _oracle_err(x0, M, b) < ORACLE_RTOL
    assert _oracle_err(x1, M1, b) < ORACLE_RTOL


def test_replay_keeps_fill_that_underflows_as_explicit_zeros():
    """The same values at the transform layer: the reference's replay
    raises; the port's keeps the zero updates as explicit zeros on the
    frozen pattern, and the replayed system and a re-bound operator solve
    the new matrix."""
    from repro.core.resilience import PatternMismatchError as RefMismatch
    from repro.core.strategies import CriticalPathRewrite as RefCriticalPath
    from repro.core.transform import replay_transform as ref_replay
    from repro.core.transform import transform as ref_transform
    from repro.sparse import generators as ref_gen
    from repro_torch.core.transform import replay_transform, transform
    from repro_torch.solver.reference import solve_transformed_seq
    from repro_torch.sparse.csr import same_pattern
    M, M_ref = generators.lung2_like(0.03), ref_gen.lung2_like(0.03)
    M1 = step_values(M, 1)
    ts = transform(M, CriticalPathRewrite(beta=8), validate=False)
    ts_ref = ref_transform(M_ref, RefCriticalPath(beta=8), validate=False,
                           codegen=False)
    with pytest.raises(RefMismatch, match="different fill"):
        ref_replay(M_ref.with_data(M1.data), ts_ref)
    r = replay_transform(M1, ts)
    assert same_pattern(r.A, ts.A) and same_pattern(r.T, ts.T)
    np.testing.assert_array_equal(r.src, ts.src)
    assert int((r.T.data == 0).sum()) > int((ts.T.data == 0).sum())
    b = _rhs(M)
    x = solve_csr_seq(M1, b)
    scale = max(1.0, float(np.abs(x).max()))
    assert float(np.abs(solve_transformed_seq(r, b) - x).max()) \
        <= 1e-12 * scale
    op = TriangularOperator.from_csr(M, tune=CriticalPathRewrite(beta=8),
                                     device="cpu", cache=False)
    op.update_values(M1)
    assert op.stats.value_updates == 1
    assert float(np.abs(np.asarray(op.solve(b)) - x).max()) <= 1e-12 * scale


# -- the entry point ----------------------------------------------------------

def test_server_main_on_the_cpu(capsys):
    assert server.main(["--smoke", "--device", "cpu", "--requests", "12",
                        "--scale", "0.02"]) == 0
    out = capsys.readouterr().out
    assert '"device": "cpu"' in out and '"checked": 12' in out
    # every entry's life cycle is in the report: all swapped, none failed
    entries = json.loads(out)["entries"]
    assert len(entries) == 3
    assert {(e["state"], e["hot_swaps"], e["tune_error"])
            for e in entries.values()} == {("hot", 1, "")}


def test_server_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        server.main(["--smoke", "--requests", "3"])


# -- on the card --------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_service_on_the_card_launches_k1_and_k2(card, L):
    """Width-1 batches through K1, padded ones through K2; the plain
    version never runs."""
    before = dict(K.LAUNCHES)
    bs = [_rhs(L, s) for s in range(4)]
    with SolveService(max_width=4, max_linger_s=60.0, auto_dispatch=False,
                      tune_mode="off", cache=False) as svc:
        one = svc.submit(bs[0], L)
        svc.pump()
        many = [svc.submit(b, L) for b in bs[1:]]
        svc.pump()
        xs = [one.result(0)] + [f.result(0) for f in many]
    for x, b in zip(xs, bs):
        assert _oracle_err(x, L, b) < ORACLE_RTOL
    assert K.LAUNCHES["sptrsv_groups"] > before["sptrsv_groups"]
    assert K.LAUNCHES["sptrsv_groups_multi"] > before["sptrsv_groups_multi"]
    assert K.LAUNCHES["plain"] == before["plain"]


@pytest.mark.cuda
def test_kernel_failure_on_the_card_reaches_the_futures(card, L,
                                                        monkeypatch):
    """A launch that fails inside a served batch resolves its futures with
    the error: no host or plain-version answer stands in."""
    before = dict(K.LAUNCHES)

    def failed_launch(packed, c_pad):
        raise RuntimeError("sptrsv_tiles_kernel launch failed: injected")

    with SolveService(max_width=4, max_linger_s=60.0, auto_dispatch=False,
                      tune_mode="off", cache=False) as svc:
        monkeypatch.setattr(K, "_launch", failed_launch)
        futs = [svc.submit(_rhs(L, s), L) for s in range(2)]
        svc.pump()
        for f in futs:
            with pytest.raises(RuntimeError, match="injected"):
                f.result(0)
        assert svc.snapshot()["failed"] == 2
    assert K.LAUNCHES["plain"] == before["plain"]
