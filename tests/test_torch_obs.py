"""The port's observability layer against the reference's, on the CPU.

* Tracing: the same span/event script under one fake clock through both
  packages' tracers gives equal Chrome trace documents and JSON-lines
  logs; the tracer's own semantics (exact durations, nesting, per-thread
  stacks, cross-thread retroactive spans) hold in the port.
* Metrics: both registries, fed the same instruments, give equal
  snapshots and Prometheus pages; `OperatorStats` is a view over its
  registry with the reference's fields (plus the port's `repacks`).
* Spans on the solve path: building, solving and re-binding an operator
  opens the reference's spans, `engine.solve` around each engine attempt
  of the fallback chain included, with the same parents.
* The disabled tracer is checked by structure, not by wall time: every
  helper returns the shared NULL_SPAN and no clock is read.
Float64 Krylov runs take the reference's iterations, so their
`krylov.residual` events agree to 1e-9 relative to scale
(tests/test_torch_iterative.py's bound).
"""
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as ref_obs
from repro.iterative import cg as ref_cg
from repro.obs import export as ref_export
from repro.obs.metrics import MetricsRegistry as RefRegistry
from repro.obs.trace import Tracer as RefTracer
from repro.solver import TriangularOperator as RefOperator
from repro.solver.operator import OperatorStats as RefStats
from repro.sparse import generators as ref_gen

from repro_torch import obs
from repro_torch.iterative import cg
from repro_torch.obs.export import (chrome_trace, prometheus_text,
                                    validate_chrome_trace,
                                    validate_prometheus_text,
                                    write_chrome_trace, write_jsonl)
from repro_torch.obs.metrics import (MetricsRegistry, default_registry,
                                     nearest_rank_percentile)
from repro_torch.obs.trace import NULL_SPAN, Tracer
from repro_torch.solver import TriangularOperator
from repro_torch.solver.operator import OperatorStats
from repro_torch.sparse import generators

torch.set_num_threads(1)

EXACT_TOL = 1e-9


@pytest.fixture(autouse=True)
def _no_global_tracer(tmp_path, monkeypatch):
    """Every test starts and ends with both packages' tracing disabled,
    and the operator's disk tier under the test's own directory."""
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "cache"))
    obs.disable()
    ref_obs.disable()
    TriangularOperator.clear_memory_cache()
    RefOperator.clear_memory_cache()
    yield
    obs.disable()
    ref_obs.disable()
    TriangularOperator.clear_memory_cache()
    RefOperator.clear_memory_cache()


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t
        self.calls = 0

    def __call__(self):
        self.calls += 1
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


def _script(tr, clk):
    """One serving-shaped trace: nested spans with attributes and events,
    a cross-thread queue span parented under the batch, an error span and
    an orphan event."""
    with tr.span("serving.batch", width=2, reason="linger") as bsp:
        tr.record_span("serving.queue", clk.t - 0.5, clk.t, parent=bsp,
                       tenant="a")
        clk.advance(0.001)
        with tr.span("operator.solve", n=10, columns=2) as sp:
            clk.advance(0.002)
            sp.event("mark", k=1, ratio=float("nan"))
            clk.advance(0.0005)
            sp.set(ms=2.5, engine_used="torch")
        clk.advance(0.001)
    try:
        with tr.span("operator.update_values", n=10):
            clk.advance(0.25)
            raise ValueError("boom")
    except ValueError:
        pass
    clk.advance(0.1)
    tr.event("loose.orphan", why="no span open")
    return tr


# -- tracing: parity ----------------------------------------------------------

def test_chrome_trace_and_jsonl_match_the_reference(tmp_path):
    clk, ref_clk = FakeClock(100.0), FakeClock(100.0)
    tr = _script(Tracer(clock=clk), clk)
    ref = _script(RefTracer(clock=ref_clk), ref_clk)
    doc = chrome_trace(tr)
    assert doc == ref_export.chrome_trace(ref)
    assert validate_chrome_trace(doc) == []
    reg, ref_reg = MetricsRegistry(prefix="t"), RefRegistry(prefix="t")
    for r in (reg, ref_reg):
        r.counter("hits", "h").inc(3, route="a")
    n = write_jsonl(tmp_path / "port.jsonl", tracer=tr, registries=[reg])
    n_ref = ref_export.write_jsonl(tmp_path / "ref.jsonl", tracer=ref,
                                   registries=[ref_reg])
    assert n == n_ref
    assert (tmp_path / "port.jsonl").read_text() == \
        (tmp_path / "ref.jsonl").read_text()
    written = write_chrome_trace(tmp_path / "t.json", tr)
    assert json.loads((tmp_path / "t.json").read_text()) == \
        json.loads(json.dumps(written))


def _feed(reg):
    reg.counter("hits", "total hits").inc(5, route="a")
    reg.counter("hits", "total hits").inc(2)
    reg.gauge("depth", "queue depth").set(2.5)
    reg.gauge("resid", "last residual", default=float("nan"))
    reg.text("source", "cache source").set('we"ird\nvalue')
    h = reg.histogram("lat_ms", "latency", bounds=(1.0, 10.0), reservoir=2)
    for v in (0.5, 5.0, 50.0):
        h.observe(v)
        h.observe(v, tenant="b")
    return reg


def test_prometheus_pages_and_snapshots_match_the_reference():
    reg, ref = _feed(MetricsRegistry("repro_test")), \
        _feed(RefRegistry("repro_test"))
    page = prometheus_text(reg)
    assert page == ref_export.prometheus_text(ref)
    assert validate_prometheus_text(page) == []
    assert json.dumps(reg.snapshot(), default=str) == \
        json.dumps(ref.snapshot(), default=str)
    # per-entry merge under one TYPE header, as the service scrapes
    merged = prometheus_text((reg, {"entry": "e1"}), (reg, {"entry": "e2"}))
    assert merged == ref_export.prometheus_text((ref, {"entry": "e1"}),
                                                (ref, {"entry": "e2"}))
    assert merged.count("# TYPE repro_test_hits counter") == 1


def test_validators_flag_what_the_reference_flags():
    tr = Tracer(clock=FakeClock())
    tr.span("never.closed").__enter__()
    bad_docs = [chrome_trace(tr),
                {"traceEvents": [{"name": "x", "ph": "X", "ts": 0.0,
                                  "dur": 1.0,
                                  "args": {"span_id": 1, "parent_id": 99}}]},
                {"nope": 1}]
    for doc in bad_docs:
        got = validate_chrome_trace(doc)
        assert got and got == ref_export.validate_chrome_trace(doc)
    for page in ("repro_x 1\n",
                 "# TYPE repro_x counter\nrepro_x{bad-label=\"v\"} 1\n",
                 "# TYPE repro_x counter\nrepro_x NaN\nrepro_x 1.5e-3\n"):
        assert validate_prometheus_text(page) == \
            ref_export.validate_prometheus_text(page)


# -- tracing: the port's own semantics ----------------------------------------

def test_span_nesting_and_exact_durations():
    clk = FakeClock()
    tr = Tracer(clock=clk)
    with tr.span("outer", n=3) as outer:
        clk.advance(1.0)
        with tr.span("inner") as inner:
            clk.advance(0.25)
            inner.event("mark", k=1)
            clk.advance(0.25)
        clk.advance(0.5)
    assert outer.duration == pytest.approx(2.0)
    assert inner.duration == pytest.approx(0.5)
    assert inner.parent_id == outer.span_id and outer.parent_id is None
    assert inner.events[0] == ("mark", pytest.approx(1.25), {"k": 1})
    assert tr.open_spans() == []
    assert [s.name for s in tr.spans()] == ["inner", "outer"]


def test_record_span_parenting_and_orphans():
    clk = FakeClock(10.0)
    tr = Tracer(clock=clk)
    with tr.span("batch") as bsp:
        sp = tr.record_span("queue", 9.0, 10.0, parent=bsp, tenant="a")
    assert sp.parent_id == bsp.span_id and sp.duration == pytest.approx(1.0)
    assert tr.record_span("queue", 0.0, 1.0, parent=NULL_SPAN).parent_id \
        is None
    tr.event("loose", why="x")
    name, t, attrs, tid = tr.orphan_events()[0]
    assert (name, t, tid) == ("loose", 10.0, threading.get_ident())


def test_per_thread_stacks_do_not_cross():
    tr = Tracer(clock=FakeClock())
    seen = {}

    def worker():
        with tr.span("child-thread") as sp:
            seen["parent"] = sp.parent_id

    with tr.span("main-thread"):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive() and seen["parent"] is None


def test_enable_disable_roundtrip():
    tr = obs.enable(clock=FakeClock())
    assert obs.enabled() and obs.get_tracer() is tr
    with obs.span("s"):
        pass
    assert [s.name for s in tr.spans()] == ["s"]
    assert obs.disable() is tr and not obs.enabled()


def test_disabled_tracer_reads_no_clock_on_a_solve():
    """The off path by structure: every module helper hands back the one
    NULL_SPAN, and a solve with tracing off calls no tracer clock (a
    tracer installed and then removed keeps its spans, gains none)."""
    L = generators.lung2_like(0.01)
    b = np.ones(L.n_rows)
    clk = FakeClock()
    tr = obs.enable(clock=clk)
    op = TriangularOperator.from_csr(L, tune="no_rewriting", device="cpu",
                                     cache=False)
    op.solve(b)
    assert clk.calls > 0 and tr.spans()
    obs.disable()
    clk.calls, before = 0, len(tr.spans())
    sp = obs.span("operator.solve", n=1)
    assert sp is NULL_SPAN and sp.set(a=1) is NULL_SPAN
    assert obs.record_span("x", 0.0, 1.0) is NULL_SPAN
    obs.event("loose")
    op.solve(b)
    op.update_values(L.with_data(L.data * 1.5))
    assert clk.calls == 0 and len(tr.spans()) == before


def test_annotate_torch_marks_spans_in_a_profiler_trace():
    from torch.profiler import ProfilerActivity, profile
    tr = obs.enable(annotate_torch=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("serving.solve", columns=2):
            torch.ones(4).sum()
    obs.disable()
    assert [s.name for s in tr.spans()] == ["serving.solve"]
    assert any(e.key == "serving.solve" for e in prof.key_averages())


# -- metrics ------------------------------------------------------------------

def test_instruments_and_percentile_formula():
    reg = MetricsRegistry(prefix="t")
    c = reg.counter("hits", "hits")
    c.inc()
    c.inc(2, route="a")
    assert c.value() == 1 and c.value(route="a") == 2 and c.total() == 3
    assert reg.counter("hits") is c
    with pytest.raises(TypeError):
        reg.gauge("hits")
    h = reg.histogram("lat", "l", bounds=(10.0,), reservoir=2)
    for v in (1.0, 2.0, 3.0, 40.0):
        h.observe(v)
    assert h.count() == 4 and h.samples() == [1.0, 2.0]
    assert h.buckets() == {10.0: 3, float("inf"): 1}
    with reg.lock:
        with reg.lock:          # one re-entrant lock for the registry
            c.inc()
    from repro.obs.metrics import nearest_rank_percentile as ref_pct
    samples = list(np.random.default_rng(0).standard_normal(37))
    for q in (0, 25, 50, 99, 100):
        assert nearest_rank_percentile(samples, q) == ref_pct(samples, q)
    assert np.isnan(nearest_rank_percentile([], 50))


def _record(st):
    st.record_solve(ms=2.0, columns=4, rounds=1, residual=1e-9)
    st.record_solve(ms=3.0, columns=1, rounds=0, residual=2e-9)
    st.record_fallback("cuda->torch", new_pair=True)
    st.record_fallback("cuda->torch")
    st.record_health_event("output:nonfinite")
    st.record_health_action("output:raised")
    return st


def test_operator_stats_is_the_reference_view_plus_repacks():
    st = _record(OperatorStats(cache_source="disk", tune_ms=12.5))
    st.record_value_update(ms=0.7, cache_source="pattern", repacks=1)
    ref = _record(RefStats(cache_source="disk", tune_ms=12.5))
    ref.record_value_update(ms=0.7, cache_source="pattern")
    assert st.to_dict() == ref.to_dict()
    assert (st.fallbacks, st.fallback_downgrades, st.last_health_event) == \
        (2, 1, "output:raised")
    assert st.repacks == 1 and st.registry.get("repacks").value() == 1
    snap, ref_snap = st.registry.snapshot(), ref.registry.snapshot()
    assert snap.pop("repacks")["series"] == {"": 1}
    assert json.dumps(snap, default=str) == json.dumps(ref_snap, default=str)
    # the page is the reference's plus the repacks family
    page = prometheus_text(st.registry)
    extra = [ln for ln in page.splitlines() if "repro_operator_repacks" in ln]
    assert len(extra) == 3
    assert "\n".join(ln for ln in page.splitlines() if ln not in extra) + \
        "\n" == ref_export.prometheus_text(ref.registry)


# -- spans on the solve path --------------------------------------------------

def _chain(tr):
    """(name, parent's name) of every span, in finishing order."""
    by_id = {s.span_id: s for s in tr.spans()}

    def parent(s):
        p = by_id.get(s.parent_id)
        return None if p is None else p.name

    return [(s.name, parent(s)) for s in tr.spans()]


def test_operator_spans_match_the_reference():
    L, L_ref = generators.lung2_like(0.01), ref_gen.lung2_like(0.01)
    b = np.random.default_rng(0).standard_normal(L.n_rows)
    tr = obs.enable(clock=FakeClock())
    op = TriangularOperator.from_csr(L, tune="avgLevelCost", device="cpu",
                                     cache=False)
    op.solve(b)
    op.update_values(L.with_data(L.data * 1.25))
    obs.disable()
    ref = ref_obs.enable(clock=FakeClock())
    ref_op = RefOperator.from_csr(L_ref, tune="avgLevelCost", cache=False)
    ref_op.solve(b)
    ref_op.update_values(L_ref.with_data(L_ref.data * 1.25))
    ref_obs.disable()
    assert _chain(tr) == _chain(ref)
    for t in (tr, ref):
        events = [n for n, *_ in t.orphan_events()]
        assert events == ["operator.cache"]
    (solve,) = [s for s in tr.spans() if s.name == "operator.solve"]
    (ref_solve,) = [s for s in ref.spans() if s.name == "operator.solve"]
    assert set(solve.attrs) == set(ref_solve.attrs)
    assert solve.attrs["rounds"] == ref_solve.attrs["rounds"]
    (upd,) = [s for s in tr.spans() if s.name == "operator.update_values"]
    assert upd.attrs["source"] == "pattern" and upd.attrs["repacks"] == 0


def test_portfolio_tune_span_and_counters():
    from repro_torch.core.portfolio import StrategyPortfolio
    L = generators.lung2_like(0.01)
    reg = default_registry()
    tunes = reg.counter("portfolio_tunes").value()
    tr = obs.enable(clock=FakeClock())
    report = StrategyPortfolio(device="cpu").tune(L)
    obs.disable()
    (sp,) = [s for s in tr.spans() if s.name == "portfolio.tune"]
    assert sp.attrs["n"] == L.n_rows and sp.attrs["candidates"] == 10
    assert sp.attrs["best"] == report.best.label
    assert reg.counter("portfolio_tunes").value() == tunes + 1
    assert reg.get("portfolio_candidate_failures") is not None
    assert reg.get("portfolio_measure_notes") is not None


def test_krylov_residual_events_match_the_reference():
    A, A_ref = generators.poisson2d_spd(16, 16), ref_gen.poisson2d_spd(16, 16)
    b = A.matvec(np.random.default_rng(3).standard_normal(A.n_rows))
    tr = obs.enable(clock=FakeClock())
    res = cg(A, torch.as_tensor(b), tol=1e-10)
    obs.disable()
    ref = ref_obs.enable(clock=FakeClock())
    with jax.enable_x64(True):
        ref_cg(A_ref, jnp.asarray(b), tol=1e-10)
    ref_obs.disable()

    def events(t):
        return [a for n, _, a, _ in t.orphan_events()
                if n == "krylov.residual"]

    got, want = events(tr), events(ref)
    assert got and len(got) <= 64 + 1
    assert [(e["driver"], e["iteration"]) for e in got] == \
        [(e["driver"], e["iteration"]) for e in want]
    r, r_ref = (np.array([e["residual"] for e in x]) for x in (got, want))
    assert np.abs(r - r_ref).max() <= EXACT_TOL * max(1.0, r_ref.max())
    hist = res.residual_norms.numpy()
    for e in got:
        assert hist[e["iteration"]] == pytest.approx(e["residual"])
