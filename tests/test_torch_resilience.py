"""The port's runtime resilience layer against the reference's, on the CPU.

Chaos suite (`pytest -m chaos`), ported case by case from
tests/test_resilience.py: the same `random_lower(120, avg_offdiag=2.5,
seed=0, max_back=20)` and `b` from `default_rng(1)` go through both
packages under the same fault (`repro.core.faults` and
`repro_torch.core.faults`), and each case asserts the same typed outcome,
the same resilience warnings (each class as often), the same
`fallbacks`, `fallback_downgrades`, `last_fallback` (engine names
mapped), `health_events` and `last_health_event`, and answers within
1e-10 of each other and of the scipy oracle where the reference holds its
own answer that tight (refined solves; unrefined float32 sweeps agree to
1e-5 relative).

Engine names: the reference's default CPU engine "scan" is the port's
plain engine "torch".  Where the reference downgrades "pallas-interpret"
to "scan", the port downgrades a second plain engine, registered here
under "torch-alt" with the chain ("torch",): legitimate on the CPU, where
no card is involved.  On a card the chain of the "cuda" engine never
holds a plain engine, whatever the table says (the resolution tests
below, and the `cuda` cases, which skip here).  The host reference
serves CPU-staged operators only: on a card the kernel serves the solve
or it raises, under every policy (the `cuda` cases).

The port's own semantics are held too: what an engine's `available()` or
`compile()` raises is memoized on the payload, what its compiled callable
raises is not.  The reference's `test_measure_failure_does_not_kill_
tuning` has no parity case: the port's tuner raises when a measurement
fails on the card (ROADMAP.md, queue 3, "By design").  Health overhead is
checked by structure, not by wall time: host matvecs and `engine.solve`
spans of a healthy solve under each level.
"""
import collections
import dataclasses
import types
import warnings

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import faults
from repro_torch.core.resilience import (EngineFallbackError,
                                         HealthPolicy, HealthRepairWarning,
                                         NumericalHealthError,
                                         resolve_health_policy)
from repro_torch.kernels import sptrsv_level as K
from repro_torch.solver import (TorchEngine, TriangularOperator,
                                engine_fallbacks, fallback_chains,
                                get_engine, register_engine,
                                set_fallback_chain)
from repro_torch.solver import engines as _engines
from repro_torch.sparse import generators

pytestmark = pytest.mark.chaos

torch.set_num_threads(1)

ALT = "torch-alt"
EXACT_TOL = 1e-10       # refined answers: port vs reference vs oracle
SWEEP_RTOL = 1e-5       # unrefined float32 sweeps, relative to max|x|
LEVELS = ("off", "on", "strict", "repair", "fallback")


class AltEngine(TorchEngine):
    """A second plain engine, the stand-in for the reference's
    "pallas-interpret" in the downgrade cases."""

    name = ALT


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """The disk tier under the test's own directory, empty memory caches,
    tracing off, and the registry and chain table restored after."""
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "ref-cache"))
    chains = fallback_chains()
    obs.disable()
    TriangularOperator.clear_memory_cache()
    yield
    obs.disable()
    TriangularOperator.clear_memory_cache()
    _engines._REGISTRY.pop(ALT, None)
    _engines._FALLBACK_CHAINS.clear()
    _engines._FALLBACK_CHAINS.update(chains)


def _alt_engine(dtypes=("float32", "float64")):
    eng = AltEngine()
    eng.dtypes = tuple(dtypes)
    register_engine(eng, overwrite=True)
    set_fallback_chain(ALT, ("torch",))
    return eng


def _port():
    from repro_torch.precond import Preconditioner
    from repro_torch.serving import SolveService
    from repro_torch.solver import sptrsv
    return types.SimpleNamespace(
        name="port", faults=faults, Op=TriangularOperator, sptrsv=sptrsv,
        gen=generators, Preconditioner=Preconditioner,
        SolveService=SolveService, kw={"device": "cpu"}, plain="torch",
        alt=ALT, prefix="torch-op-")


def _ref():
    from repro.core import faults as ref_faults
    from repro.precond import Preconditioner
    from repro.serving import SolveService
    from repro.solver import TriangularOperator as RefOp
    from repro.solver import sptrsv
    from repro.sparse import generators as ref_gen
    RefOp.clear_memory_cache()
    return types.SimpleNamespace(
        name="ref", faults=ref_faults, Op=RefOp, sptrsv=sptrsv, gen=ref_gen,
        Preconditioner=Preconditioner, SolveService=SolveService, kw={},
        plain="scan", alt="pallas-interpret", prefix="op-")


# reference engine names -> the port's
NAME_MAP = {"scan": "torch", "pallas-interpret": ALT}


def _mapped(text: str) -> str:
    for ref_name, port_name in NAME_MAP.items():
        text = text.replace(ref_name, port_name)
    return text


def _L(side):
    return side.gen.random_lower(120, avg_offdiag=2.5, seed=0, max_back=20)


def _b(n=120):
    return np.random.default_rng(1).standard_normal(n)


def _oracle(L, b):
    import scipy.sparse as sp
    from scipy.sparse.linalg import spsolve_triangular
    mat = sp.csr_matrix((np.asarray(L.data, np.float64), L.indices,
                         L.indptr), shape=L.shape)
    return spsolve_triangular(mat, np.asarray(b, np.float64), lower=True)


@dataclasses.dataclass
class Outcome:
    """What one side's run of a case gave: its answer or typed error, the
    resilience warnings by class, the operator's stats and the case's own
    observations."""

    x: np.ndarray | None
    error: BaseException | None
    warnings: collections.Counter
    stats: dict
    seen: dict


STAT_FIELDS = ("fallbacks", "fallback_downgrades", "last_fallback",
               "health_events", "last_health_event", "solves")


def _observe(side, case) -> Outcome:
    box = {}
    x = err = None
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        try:
            x = case(side, box)
        except Exception as e:      # noqa: BLE001 - compared below
            err = e
    # each package's own ResilienceWarning subclasses, by class name
    caught = collections.Counter(
        w.category.__name__ for w in rec
        if any(c.__name__ == "ResilienceWarning"
               for c in w.category.__mro__))
    op = box.pop("op", None)
    stats = {} if op is None else {f: getattr(op.stats, f)
                                   for f in STAT_FIELDS}
    return Outcome(x=None if x is None else np.asarray(x), error=err,
                   warnings=caught, stats=stats, seen=box)


def _same_error(port, ref):
    if ref is None or port is None:
        assert port is None and ref is None, (port, ref)
        return
    assert type(port).__name__ == type(ref).__name__, (port, ref)
    for attr in ("stage", "fallbacks", "detail"):
        if hasattr(ref, attr):
            assert getattr(port, attr) == getattr(ref, attr), attr
    if hasattr(ref, "attempts"):
        assert [n for n, _ in port.attempts] == \
            [NAME_MAP.get(n, n) for n, _ in ref.attempts]
        assert [_mapped(r) for _, r in ref.attempts] == \
            [r for _, r in port.attempts]


def _parity(case, *, tol=EXACT_TOL, oracle=True) -> tuple:
    """Run `case` through both packages and hold the port to the
    reference; returns the two outcomes."""
    ref = _observe(_ref(), case)
    port = _observe(_port(), case)
    _same_error(port.error, ref.error)
    assert port.warnings == ref.warnings
    ref_stats = dict(ref.stats)
    if ref_stats:
        ref_stats["last_fallback"] = _mapped(ref_stats["last_fallback"])
    assert port.stats == ref_stats
    assert port.seen == ref.seen
    if ref.x is not None:
        scale = max(1.0, float(np.abs(ref.x).max()))
        assert port.x.shape == ref.x.shape
        assert float(np.abs(port.x - ref.x).max()) <= tol * scale
        if oracle:
            x_ref = _oracle(_L(_port()), _b())
            assert float(np.abs(port.x - x_ref).max()) <= tol * max(
                1.0, float(np.abs(x_ref).max()))
    return port, ref


# -- health policy resolution -------------------------------------------------


def test_policy_resolution_named_and_env(monkeypatch):
    from repro.core import resilience as R
    for level in LEVELS + ("0", "1"):
        assert dataclasses.asdict(resolve_health_policy(level)) == \
            dataclasses.asdict(R.resolve_health_policy(level)), level
        monkeypatch.setenv("REPRO_HEALTH_CHECKS", level)
        assert dataclasses.asdict(resolve_health_policy(None)) == \
            dataclasses.asdict(R.resolve_health_policy(None)), level
    assert resolve_health_policy("repair").on_nonfinite == "repair"
    monkeypatch.setenv("REPRO_HEALTH_CHECKS", "fallback")
    assert resolve_health_policy(None).on_nonfinite == "fallback"
    monkeypatch.delenv("REPRO_HEALTH_CHECKS")
    assert resolve_health_policy(None) == HealthPolicy()
    p = HealthPolicy(residual_tol=1e-3)
    assert resolve_health_policy(p) is p
    with pytest.raises(ValueError, match="unknown health policy"):
        resolve_health_policy("bogus")
    with pytest.raises(TypeError):
        resolve_health_policy(1.5)
    with pytest.raises(ValueError, match="on_nonfinite"):
        HealthPolicy(on_nonfinite="explode")
    assert not HealthPolicy.off().enabled and HealthPolicy().enabled


# -- input / output health guards ---------------------------------------------


def test_nonfinite_rhs_raises_typed_input_error():
    def case(side, box):
        op = box["op"] = side.Op.from_csr(_L(side), cache=False, **side.kw)
        bad = _b()
        bad[3] = np.nan
        with pytest.raises(Exception) as ei:
            op.solve(bad)
        box["stage"] = ei.value.stage
        box["type"] = type(ei.value).__name__
        bad[3] = np.inf
        op.solve(bad)

    port, ref = _parity(case)
    assert port.seen == {"stage": "input", "type": "NumericalHealthError"}
    assert isinstance(port.error, NumericalHealthError)
    assert port.stats["solves"] == 0


@pytest.mark.parametrize("health", ["on", "fallback", "repair"])
def test_poisoned_payload(health):
    """"on" raises; "fallback" serves the host reference; "repair" spends
    its refinement rounds, then escalates to the reference."""
    def case(side, box):
        with side.faults.nan_schedule_payload():
            op = box["op"] = side.Op.from_csr(_L(side), cache=False,
                                              **side.kw)
            return op.solve(_b(), health=health)

    port, _ = _parity(case)
    if health == "on":
        assert isinstance(port.error, NumericalHealthError)
        assert port.error.stage == "output" and port.error.fallbacks == ()
        assert port.stats["last_health_event"] == "output:raised"
    else:
        assert port.warnings == {"HealthRepairWarning": 1}
        assert port.stats["last_health_event"] == "output:reference"
        assert port.stats["health_events"] == 1


def test_wrong_values_caught_only_by_strict():
    """The silent-wrong-answer fault class: finite output, wrong numbers.
    Finiteness checks pass; only the strict residual check catches it."""
    def silent(side, box):
        with side.faults.wrong_schedule_values(3.0):
            op = box["op"] = side.Op.from_csr(_L(side), cache=False,
                                              **side.kw)
            return op.solve(_b(), max_refine=0)

    def strict(side, box):
        with side.faults.wrong_schedule_values(3.0):
            op = box["op"] = side.Op.from_csr(_L(side), cache=False,
                                              **side.kw)
            op.solve(_b(), max_refine=0, health="strict")

    port, _ = _parity(silent, tol=SWEEP_RTOL, oracle=False)
    assert np.isfinite(port.x).all()
    assert np.abs(port.x - _oracle(_L(_port()), _b())).max() > 1e-3
    port, _ = _parity(strict)
    assert port.error.stage == "residual" and "residual" in str(port.error)


def test_strict_passes_on_healthy_solves():
    def case(side, box):
        op = box["op"] = side.Op.from_csr(_L(side), cache=False, **side.kw)
        return op.solve(_b(), health="strict")

    port, _ = _parity(case)
    assert port.stats["health_events"] == 0


# -- engine fallback chains ---------------------------------------------------


def test_engine_compile_failure_downgrades():
    _alt_engine()

    def case(side, box):
        with side.faults.fail_engine_compile(side.alt) as count:
            op = box["op"] = side.Op.from_csr(_L(side), cache=False,
                                              engine=side.alt, **side.kw)
            x = op.solve(_b())
        box["failed"] = count["failed"]
        return x

    port, _ = _parity(case)
    assert port.seen == {"failed": 1}
    assert port.warnings == {"EngineFallbackWarning": 1}
    assert port.stats["fallbacks"] == 1
    assert port.stats["last_fallback"] == f"{ALT}->torch"


def test_downgrade_warns_once_but_counts_every_solve():
    _alt_engine()

    def case(side, box):
        with side.faults.fail_engine_compile(side.alt):
            op = box["op"] = side.Op.from_csr(_L(side), cache=False,
                                              engine=side.alt, **side.kw)
            op.solve(_b())
            return op.solve(_b())

    port, _ = _parity(case)
    assert port.warnings == {"EngineFallbackWarning": 1}
    assert port.stats["fallbacks"] == 2
    assert port.stats["fallback_downgrades"] == 1


def test_engine_unavailable_downgrades():
    _alt_engine()

    def case(side, box):
        with side.faults.engine_unavailable(side.alt):
            op = box["op"] = side.Op.from_csr(_L(side), cache=False,
                                              engine=side.alt, **side.kw)
            return op.solve(_b())

    port, _ = _parity(case)
    assert port.stats["last_fallback"] == f"{ALT}->torch"


def test_dtype_capability_rejection_downgrades():
    """A float64 schedule on a float32-only engine: the capability check
    raises inside compile and the chain serves through the plain engine."""
    _alt_engine(dtypes=("float32",))

    def case(side, box):
        op = box["op"] = side.Op.from_csr(_L(side), cache=False,
                                          engine=side.alt, dtype=np.float64,
                                          **side.kw)
        return op.solve(_b())

    port, _ = _parity(case, tol=1e-5)
    assert port.warnings == {"EngineFallbackWarning": 1}
    assert port.stats["last_fallback"] == f"{ALT}->torch"


def test_exhausted_chain_raises_named_attempts():
    def case(side, box):
        with side.faults.fail_engine_compile(side.plain):
            op = box["op"] = side.Op.from_csr(_L(side), cache=False,
                                              **side.kw)
            op.solve(_b())

    port, _ = _parity(case)
    assert isinstance(port.error, EngineFallbackError)
    assert [name for name, _ in port.error.attempts] == ["torch"]
    assert "injected compile failure" in str(port.error)


def test_exhausted_chain_with_fallback_policy_serves_reference():
    def case(side, box):
        with side.faults.fail_engine_compile(side.plain):
            op = box["op"] = side.Op.from_csr(_L(side), cache=False,
                                              **side.kw)
            return op.solve(_b(), health="fallback")

    port, _ = _parity(case)
    assert port.warnings == {"HealthRepairWarning": 1}
    assert port.stats["last_health_event"] == "engine:reference"


# -- hardened disk cache ------------------------------------------------------


@pytest.mark.parametrize("mode", ["garbage", "truncate", "stale"])
def test_corrupt_entries_quarantined_not_deleted(tmp_path, mode):
    def case(side, box):
        d = tmp_path / side.name
        kw = dict(side.kw, tune="no_rewriting", cache_dir=d)
        side.Op.from_csr(_L(side), **kw)
        box["corrupted"] = len(side.faults.corrupt_cache_entries(d,
                                                                 mode=mode))
        side.Op.clear_memory_cache()
        op = side.Op.from_csr(_L(side), **kw)
        box["rebuilt"] = op.stats.cache_source
        box["quarantined"] = len(list((d / ".bad").glob(
            f"{side.prefix}*.pkl")))
        side.Op.clear_memory_cache()
        op = box["op"] = side.Op.from_csr(_L(side), **kw)
        box["reloaded"] = op.stats.cache_source
        return op.solve(_b())

    port, _ = _parity(case)
    assert port.seen == {"corrupted": 1, "rebuilt": "built",
                         "quarantined": 1, "reloaded": "disk"}
    assert port.warnings == {"CacheQuarantineWarning": 1}


# -- pattern drift ------------------------------------------------------------


def test_pattern_drift_rejected_by_update_values_and_refactor():
    def case(side, box):
        L = _L(side)
        op = box["op"] = side.Op.from_csr(L, "avgLevelCost", cache=False,
                                          **side.kw)
        x_before = np.asarray(op.solve(_b())).copy()
        drifted = side.faults.pattern_drift(L)
        box["same_size"] = (drifted.nnz == L.nnz and
                            drifted.shape == L.shape)
        try:
            op.update_values(drifted)
        except Exception as e:      # noqa: BLE001 - compared below
            box["update_values"] = type(e).__name__
        box["untouched"] = bool(np.array_equal(np.asarray(op.solve(_b())),
                                               x_before))
        A = side.gen.poisson2d_spd(10, 10)
        P = side.Preconditioner.ic0(A, "avgLevelCost", cache=False,
                                    **side.kw)
        try:
            P.refactor(side.faults.pattern_drift(A))
        except Exception as e:      # noqa: BLE001 - compared below
            box["refactor"] = type(e).__name__
        return x_before

    port, _ = _parity(case)
    assert port.seen == {"same_size": True,
                         "update_values": "PatternMismatchError",
                         "untouched": True,
                         "refactor": "PatternMismatchError"}


# -- tuner faults through the serving registry --------------------------------


def test_fail_tuner_degrades_entry_but_serving_continues():
    def case(side, box):
        L, b = _L(side), _b()
        with side.faults.fail_tuner() as count:
            with side.SolveService(max_width=4, max_linger_s=0.001,
                                   workers=2, tune_mode="background",
                                   cache=False, **side.kw) as svc:
                x0 = svc.submit(b, L).result(120)
                assert svc.wait_warm(timeout=120)
                x1 = svc.submit(b, L).result(120)
                reg = svc.registry.stats()
        entry = next(iter(reg["entries"].values()))
        box.update(calls=count["calls"], states=dict(reg["states"]),
                   hot_swaps=reg["hot_swaps"],
                   tuner_failures=reg["tuner_failures"],
                   strategy=entry["strategy"],
                   error="injected tuner failure" in entry["tune_error"])
        return np.stack([np.asarray(x0, np.float64),
                         np.asarray(x1, np.float64)], 1)

    port, ref = _parity(case, tol=SWEEP_RTOL, oracle=False)
    assert port.seen == {"calls": 1, "states": {"degraded": 1},
                         "hot_swaps": 0, "tuner_failures": 1,
                         "strategy": "no_rewriting", "error": True}
    assert port.warnings == {"TunerFailureWarning": 1}
    x_ref = _oracle(_L(_port()), _b())
    assert np.abs(port.x - x_ref[:, None]).max() <= 5e-5 * max(
        1.0, float(np.abs(x_ref).max()))


def test_slow_tuner_never_blocks_the_request_path():
    """With the tuner stalled, a burst of requests completes while the
    entry is still warming; the swap lands afterwards anyway."""
    def case(side, box):
        L, b = _L(side), _b()
        with side.faults.slow_tuner(delay_s=0.6) as count:
            with side.SolveService(max_width=4, max_linger_s=0.001,
                                   workers=2, tune_mode="background",
                                   cache=False, **side.kw) as svc:
                xs = [svc.submit(b, L).result(120) for _ in range(4)]
                box["during"] = dict(svc.registry.stats()["states"])
                assert svc.wait_warm(timeout=120)
                reg = svc.registry.stats()
        box.update(calls=count["calls"], states=dict(reg["states"]),
                   hot_swaps=reg["hot_swaps"])
        return np.stack([np.asarray(x, np.float64) for x in xs], 1)

    port, _ = _parity(case, tol=SWEEP_RTOL, oracle=False)
    assert port.seen == {"during": {"warming": 1}, "calls": 1,
                         "states": {"hot": 1}, "hot_swaps": 1}


# -- the profiler's slow step -------------------------------------------------


def test_slow_step_found_by_argmax():
    """A stall injected into step 3 of every timed pass of the step-wise
    profiler is step 3's argmax and lands above 25 ms, in both
    packages."""
    def case(side, box):
        if side.name == "port":
            from repro_torch.core.strategies import NoRewrite
            from repro_torch.core.transform import transform
            from repro_torch.obs.profile import profile_schedule
            from repro_torch.solver.schedule import schedule_for_transformed
            kw = {"device": "cpu", "engine": "torch"}
        else:
            from repro.core.strategies import NoRewrite
            from repro.core.transform import transform
            from repro.obs.profile import profile_schedule
            from repro.solver.schedule import schedule_for_transformed
            kw = {}
        ts = transform(_L(side), NoRewrite(), validate=False, codegen=False)
        sched = schedule_for_transformed(ts, chunk=64, max_deps=8)
        with side.faults.slow_step(3, 0.05):
            prof = profile_schedule(sched, ts.preamble(_b()), reps=1,
                                    warmup=1, **kw)
        box["steps"] = sched.num_steps
        box["argmax"] = int(np.argmax(prof.step_ms))
        box["stalled"] = bool(prof.step_ms[3] >= 45.0)
        hist = prof.step_histogram()
        box["bucket"] = next(i for i, bnd in enumerate(hist["bounds"])
                             if prof.step_ms[3] <= bnd)

    port, _ = _parity(case)
    assert port.seen["steps"] > 4
    assert port.seen["argmax"] == 3 and port.seen["stalled"]


# -- facade pass-through ------------------------------------------------------


def test_sptrsv_health_passthrough():
    def case(side, box):
        bad = _b()
        bad[0] = np.nan
        try:
            side.sptrsv(_L(side), bad, cache=False, **side.kw)
        except Exception as e:      # noqa: BLE001 - compared below
            box["bad"] = type(e).__name__
        with side.faults.nan_schedule_payload():
            return side.sptrsv(_L(side), _b(), cache=False,
                               health="fallback", **side.kw)

    port, _ = _parity(case)
    assert port.seen == {"bad": "NumericalHealthError"}
    assert port.warnings == {"HealthRepairWarning": 1}


def test_preconditioner_apply_health_passthrough():
    def case(side, box):
        A = side.gen.poisson2d_spd(6, 6)
        P = side.Preconditioner.ic0(A, tune="no_rewriting", cache=False,
                                    **side.kw)
        try:
            P.apply(np.full(A.n_rows, np.nan))
        except Exception as e:      # noqa: BLE001 - compared below
            box["bad"] = type(e).__name__
        z = P.apply(np.ones(A.n_rows), health="strict", max_refine=3)
        box["finite"] = bool(np.isfinite(z).all())
        return z

    port, _ = _parity(case, oracle=False)
    assert port.seen == {"bad": "NumericalHealthError", "finite": True}


# -- health overhead, by structure --------------------------------------------


def _solve_structure(side, level, max_refine, monkeypatch):
    """(host matvecs, engine.solve spans, refinement rounds) of one
    healthy solve under `level`, the operator built and warmed first."""
    if side.name == "port":
        from repro_torch.sparse.csr import CSR
        tracing = obs
    else:
        from repro import obs as tracing
        from repro.sparse.csr import CSR
    op = side.Op.from_csr(_L(side), cache=False, **side.kw)
    op.solve(_b())
    rounds = op.stats.refine_rounds
    calls = {"n": 0}
    real = CSR.matvec

    def counted(self, *args, **kwargs):
        calls["n"] += 1
        return real(self, *args, **kwargs)

    monkeypatch.setattr(CSR, "matvec", counted)
    tr = tracing.enable()
    try:
        op.solve(_b(), health=level, max_refine=max_refine)
    finally:
        tracing.disable()
        monkeypatch.setattr(CSR, "matvec", real)
    spans = sum(s.name == "engine.solve" for s in tr.spans())
    return calls["n"], spans, op.stats.refine_rounds - rounds


@pytest.mark.parametrize("max_refine", [0, 6])
def test_happy_path_health_overhead_is_structural(monkeypatch, max_refine):
    """Health checks add no device solve and no host solve to a healthy
    solve: under every level the same engine.solve spans as "off", and a
    host matvec more only where "strict" has no residual yet (max_refine
    =0).  The reference's counts are the same."""
    port, ref = _port(), _ref()
    got = {lvl: _solve_structure(port, lvl, max_refine, monkeypatch)
           for lvl in LEVELS}
    want = {lvl: _solve_structure(ref, lvl, max_refine, monkeypatch)
            for lvl in LEVELS}
    assert got == want
    off = got["off"]
    for lvl, (matvecs, spans, _) in got.items():
        assert spans == off[1], lvl
        extra = 1 if (lvl == "strict" and max_refine == 0) else 0
        assert matvecs == off[0] + extra, lvl
    if max_refine == 0:
        assert off[:2] == (0, 1)


# -- the port's own: the memo, and no plain engine on a card ------------------


def test_call_failure_is_not_memoized():
    """What the compiled callable raises fails that solve only: the next
    solve on the same operator is served by the same engine."""
    L, b = _L(_port()), _b()
    op = TriangularOperator.from_csr(L, cache=False, device="cpu")
    real = TriangularOperator._device_solve
    fired = {"n": 0}

    def once(self, c, engine):
        if not fired["n"]:
            fired["n"] += 1
            raise RuntimeError("injected kernel failure")
        return real(self, c, engine)

    TriangularOperator._device_solve = once
    try:
        with pytest.raises(EngineFallbackError,
                           match="injected kernel failure") as ei:
            op.solve(b)
        assert [n for n, _ in ei.value.attempts] == ["torch"]
        assert op._runtime.get("engine_failures", {}) == {}
        x = op.solve(b)
    finally:
        TriangularOperator._device_solve = real
    assert fired["n"] == 1
    np.testing.assert_allclose(x, _oracle(L, b), rtol=1e-8, atol=1e-10)
    assert op.stats.fallbacks == 0


@pytest.mark.parametrize("fault", ["compile", "unavailable"])
def test_compile_and_availability_failures_are_memoized(fault):
    """What available() and compile() raise is kept on the payload: after
    the fault is gone the same operator still refuses the engine without
    asking it again, and a fresh operator serves."""
    L, b = _L(_port()), _b()
    inject = faults.fail_engine_compile("torch") if fault == "compile" \
        else faults.engine_unavailable("torch")
    with inject:
        op = TriangularOperator.from_csr(L, cache=False, device="cpu")
        with pytest.raises(EngineFallbackError) as first:
            op.solve(b)
    assert "torch" in op._runtime["engine_failures"]
    eng = get_engine("torch")
    with faults.fail_engine_compile("torch") as count:
        with pytest.raises(EngineFallbackError,
                           match="previously failed") as again:
            op.solve(b)
    assert count["calls"] == 0          # the engine was not asked again
    assert [n for n, _ in again.value.attempts] == \
        [n for n, _ in first.value.attempts] == ["torch"]
    with pytest.warns(HealthRepairWarning, match="host reference"):
        x = op.solve(b, health="fallback")
    assert op.stats.last_health_event == "engine:reference"
    np.testing.assert_allclose(x, _oracle(L, b), rtol=1e-8, atol=1e-10)
    fresh = TriangularOperator.from_csr(L, cache=False, device="cpu")
    np.testing.assert_allclose(fresh.solve(b), x, rtol=1e-8, atol=1e-10)
    assert eng.available()


def test_card_chain_never_holds_the_plain_engine():
    """Pure resolution: a chain naming a plain engine resolves to nothing
    for a schedule on a card, and to that engine on the CPU."""
    assert fallback_chains() == {"cuda": (), "torch": (),
                                 "sharded": ("cuda", "torch")}
    cuda, plain = get_engine("cuda"), get_engine("torch")
    assert plain.plain and not cuda.plain
    alt = _alt_engine()
    set_fallback_chain("cuda", ("torch", ALT))
    assert engine_fallbacks(cuda, device=torch.device("cuda")) == ()
    assert engine_fallbacks(cuda, device="cuda:0") == ()
    assert engine_fallbacks(cuda, device=torch.device("cpu")) == \
        (plain, alt)
    assert engine_fallbacks(cuda) == (plain, alt)
    set_fallback_chain("cuda", ("nonexistent", "cuda", "torch"))
    assert engine_fallbacks(cuda, device="cpu") == (plain,)
    set_fallback_chain("cuda", ())
    assert engine_fallbacks(cuda, device="cuda") == ()


def _world_of_one(backend="gloo"):
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def test_mesh_loss_downgrades_sharded_to_torch():
    """The reference's test_mesh_loss_downgrades_sharded_to_scan: a lost
    mesh fails the sharded lowering, and the sharded chain serves the
    solve; for a CPU-staged operator that is the plain body
    ("sharded->torch", the reference's "sharded->scan")."""
    import torch.distributed as dist

    def case(side, box):
        with side.faults.lose_mesh():
            op = box["op"] = side.Op.from_csr(_L(side), cache=False,
                                              engine="sharded", **side.kw)
            return op.solve(_b())

    _world_of_one()
    try:
        port, _ = _parity(case)
    finally:
        dist.destroy_process_group()
    assert port.warnings == {"EngineFallbackWarning": 1}
    assert port.stats["last_fallback"] == "sharded->torch"


def test_sharded_chain_resolves_by_the_staged_device():
    """("cuda", "torch"): K1 for a schedule on a card, the plain body on
    the CPU — never the plain engine on a card, never K1 on the CPU."""
    sharded = get_engine("sharded")
    cuda, plain = get_engine("cuda"), get_engine("torch")
    assert not sharded.plain
    assert engine_fallbacks(sharded, device="cuda") == (cuda,)
    assert engine_fallbacks(sharded, device="cuda:0") == (cuda,)
    assert engine_fallbacks(sharded, device="cpu") == (plain,)
    assert all(sharded not in engine_fallbacks(get_engine(n), device=d)
               for n in ("cuda", "torch") for d in ("cpu", "cuda"))


def test_explicit_plain_engine_is_the_callers_choice():
    """engine="torch" asked for by name serves; it is no fallback."""
    L, b = _L(_port()), _b()
    op = TriangularOperator.from_csr(L, cache=False, device="cpu",
                                     engine="torch")
    x = op.solve(b, engine="torch")
    assert op.stats.fallbacks == 0 and op.stats.last_fallback == ""
    np.testing.assert_allclose(x, _oracle(L, b), rtol=1e-8, atol=1e-10)


# -- on a card (skip here) ----------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_op(**kw):
    return TriangularOperator.from_csr(_L(_port()), tune="no_rewriting",
                                       cache=False, **kw)


@pytest.mark.cuda
def test_cuda_healthy_solves_are_k1s_under_every_recovering_level(
        cuda_device):
    op = _card_op()
    b = _b()
    xs = []
    for level in ("on", "repair", "fallback"):
        before = K.LAUNCHES["sptrsv_groups"]
        xs.append(op.solve(b, max_refine=0, health=level))
        assert K.LAUNCHES["sptrsv_groups"] == before + 1
    assert all(np.array_equal(xs[0], x) for x in xs[1:])
    assert op.stats.fallbacks == 0 and op.stats.health_events == 0
    before = K.LAUNCHES["sptrsv_groups_multi"]
    X = op.solve(np.random.default_rng(2).standard_normal((120, 8)),
                 health="repair")
    assert K.LAUNCHES["sptrsv_groups_multi"] > before
    assert X.shape == (120, 8) and op.stats.last_residual <= 1e-10


@pytest.mark.cuda
def test_cuda_poisoned_payload_repairs_through_k1_then_raises(cuda_device):
    """On a card the host reference never serves: "fallback" raises, and
    "repair" spends its rounds through K1, then raises."""
    b = _b()
    with faults.nan_schedule_payload():
        op = _card_op()
    for level in ("on", "fallback"):
        with pytest.raises(NumericalHealthError):
            op.solve(b, health=level)
    before = K.LAUNCHES["sptrsv_groups"]
    with pytest.raises(NumericalHealthError) as ei:
        op.solve(b, health="repair")
    assert ei.value.fallbacks == ("repair",)
    assert K.LAUNCHES["sptrsv_groups"] > before + 1    # solve + a round
    assert op.stats.last_health_event == "output:raised"
    assert K.LAUNCHES["plain"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["compile", "unavailable"])
def test_cuda_dead_chain_raises_under_every_policy(cuda_device, fault):
    set_fallback_chain("cuda", ("torch",))      # never resolved on a card
    b = _b()
    inject = faults.fail_engine_compile("cuda") if fault == "compile" \
        else faults.engine_unavailable("cuda")
    with inject:
        op = _card_op()
        before = dict(K.LAUNCHES)
        for level in ("on", "repair", "fallback"):
            with pytest.raises(EngineFallbackError) as ei:
                op.solve(b, health=level)
            assert [n for n, _ in ei.value.attempts] == ["cuda"]
        assert dict(K.LAUNCHES) == before
    assert op.stats.health_events == 0
    with pytest.raises(EngineFallbackError, match="previously failed"):
        op.solve(b, health="fallback")
    before = K.LAUNCHES["sptrsv_groups"]
    _card_op().solve(b, max_refine=0)
    assert K.LAUNCHES["sptrsv_groups"] == before + 1


@pytest.mark.cuda
def test_cuda_staging_failure_at_build_is_not_memoized(cuda_device,
                                                       monkeypatch):
    """A build whose staging raises fails that build only: a later memory
    hit of the same matrix stages anew and serves through K1."""
    from repro_torch.solver import levelset
    L, b = _L(_port()), _b()
    real = levelset.to_device
    fired = {"n": 0}

    def once(*args, **kwargs):
        if not fired["n"]:
            fired["n"] += 1
            raise RuntimeError("injected staging failure")
        return real(*args, **kwargs)

    monkeypatch.setattr(levelset, "to_device", once)
    with pytest.raises(RuntimeError, match="injected staging"):
        TriangularOperator.from_csr(L, tune="no_rewriting")
    op = TriangularOperator.from_csr(L, tune="no_rewriting")
    assert op.stats.cache_source == "memory"
    assert op._runtime.get("engine_failures", {}) == {}
    before = K.LAUNCHES["sptrsv_groups"]
    op.solve(b, max_refine=0)
    assert K.LAUNCHES["sptrsv_groups"] == before + 1


@pytest.mark.cuda
def test_cuda_transient_launch_failure_is_not_memoized(cuda_device,
                                                       monkeypatch):
    op = _card_op()
    b = _b()
    real = K._launch
    fired = {"n": 0}

    def once(packed, c_pad):
        if not fired["n"]:
            fired["n"] += 1
            raise RuntimeError("injected launch failure")
        return real(packed, c_pad)

    monkeypatch.setattr(K, "_launch", once)
    with pytest.raises(EngineFallbackError, match="injected launch"):
        op.solve(b)
    before = K.LAUNCHES["sptrsv_groups"]
    op.solve(b, max_refine=0)
    assert K.LAUNCHES["sptrsv_groups"] == before + 1


@pytest.mark.cuda
def test_cuda_mesh_loss_is_served_by_k1(cuda_device):
    """A lost mesh on a card: the sharded chain serves the solve through
    K1 (which packs its tiles at that first use), with the warning and
    "sharded->cuda"; the plain body never runs."""
    import torch.distributed as dist
    L, b = _L(_port()), _b()
    torch.cuda.set_device(0)
    _world_of_one("nccl")
    try:
        with faults.lose_mesh():
            op = TriangularOperator.from_csr(L, tune="no_rewriting",
                                             cache=False, engine="sharded")
            assert "packed" not in op._payload
            before = dict(K.LAUNCHES)
            with pytest.warns(Warning, match="mesh"):
                x = op.solve(b)
    finally:
        dist.destroy_process_group()
    assert op.device.type == "cuda"
    assert op.stats.last_fallback == "sharded->cuda"
    assert K.LAUNCHES["sptrsv_groups"] > before["sptrsv_groups"]
    assert K.LAUNCHES["plain"] == before["plain"]
    np.testing.assert_allclose(x, _oracle(L, b), rtol=1e-8, atol=1e-10)
