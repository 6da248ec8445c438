"""Fault-injection harness: chaos-test the solve path's resilience layer.

Port of `repro.core.faults`.  Each injector makes one failure class real,
so the tests and `chip_smoke.py` can prove that every fault either
recovers (via `repro_torch.core.resilience`'s guards and the operator's
repair and host-reference paths) or raises a typed, actionable error:

* static defects the verifier must reject — a reordered step, a row
  finalized twice, an out-of-bounds gather index, a corrupt replay plan:
  `health="strict"` rejects every class with a typed error naming its
  check before anything is packed or launched;
* payload faults — a NaN-poisoned or finitely wrong schedule, a poisoned
  value re-bind, a drifted pattern (`pattern_drift`);
* runtime faults — an engine whose compile fails (`fail_engine_compile`)
  or that reports itself unavailable (`engine_unavailable`), a failing or
  stalled tuner (`fail_tuner`, `slow_tuner`), corrupt disk-cache entries
  (`corrupt_cache_entries`), a stalled profiler step (`slow_step`), a
  lost mesh (`lose_mesh`: the sharded lowering fails, and a sharded
  operator falls back to K1 on a card, to the plain body on the CPU), a
  sharded step that raises on this rank (`fail_sharded_step`: every rank
  of the mesh raises the same `ShardedCallError`), a measured mode's
  sweep that raises on this rank (`fail_measurement`: under a mesh the
  same).

    from repro_torch.core import faults

    with faults.reorder_schedule_step():
        TriangularOperator.from_csr(L, "avgLevelCost", cache=False,
                                    health="strict")  # ScheduleInvariantError

    with faults.nan_schedule_payload():
        op = TriangularOperator.from_csr(L, cache=False)      # poisoned
        op.solve(b, health="fallback")  # the host reference serves on the
                                        # CPU; on a card it raises

    with faults.fail_engine_compile("cuda"):
        op = TriangularOperator.from_csr(L, cache=False)
        op.solve(b)          # EngineFallbackError: the chain is empty

Injectors patch the port's own seams (`solver.schedule.
schedule_for_transformed`, `solver.schedule.repack_schedule_values`,
`core.transform.transform`, the engine registry's instances,
`StrategyPortfolio.tune`, `obs.profile._STEP_FAULT`,
`solver.distributed.lower_sharded`, `solver.distributed._STEP_FAULT`,
`solver.operator._SWEEP_FAULT`) —
never torch or numpy — so a fault is scoped, deterministic, and cannot
leak outside the context.  The schedule faults reach the SpTRSV kernel's
packed tiles on a card, since the operator packs the schedule they
return.  They are test
and tooling utilities: nothing in the serving path imports this module.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import pickle
from pathlib import Path

import numpy as np

__all__ = [
    "poison_schedule", "scale_schedule", "nan_schedule_payload",
    "wrong_schedule_values", "corrupt_values_payload", "pattern_drift",
    "corrupt_cache_entries", "fail_engine_compile", "engine_unavailable",
    "fail_tuner", "slow_tuner", "slow_step", "lose_mesh",
    "fail_sharded_step", "fail_measurement",
    # static defects the analysis verifier must reject
    "swap_schedule_steps", "duplicate_schedule_row", "oob_schedule_index",
    "corrupt_plan", "reorder_schedule_step", "duplicate_lane_row",
    "oob_ell_index", "corrupt_replay_plan",
]


@contextlib.contextmanager
def _patched(obj, name: str, value):
    """Set an attribute for the context's duration; restores exactly the
    prior state (including 'attribute absent from the instance dict')."""
    missing = object()
    prior = obj.__dict__.get(name, missing) if hasattr(obj, "__dict__") \
        else getattr(obj, name, missing)
    setattr(obj, name, value)
    try:
        yield
    finally:
        if prior is missing:
            try:
                delattr(obj, name)
            except AttributeError:  # pragma: no cover - class attr shadowed
                pass
        else:
            setattr(obj, name, prior)


# -- schedule-payload faults --------------------------------------------------


def poison_schedule(sched, value: float = np.nan):
    """A copy of a LevelSchedule whose per-row 1/diag payload is `value`
    everywhere — every device solve through it emits `value`-poisoned
    output while shapes, steps, and engine lowering stay valid."""
    groups = tuple(
        dataclasses.replace(g, dinv=np.full_like(g.dinv, value))
        for g in sched.groups)
    return dataclasses.replace(sched, groups=groups)


def scale_schedule(sched, factor: float):
    """A copy with every 1/diag payload scaled by `factor`: a finite but
    WRONG schedule — the silent-wrong-answer fault class that only a
    residual check can catch."""
    groups = tuple(
        dataclasses.replace(g, dinv=g.dinv * factor) for g in sched.groups)
    return dataclasses.replace(sched, groups=groups)


@contextlib.contextmanager
def _schedule_fault(mutate):
    from ..solver import schedule as _sched
    real = _sched.schedule_for_transformed

    def faulty(*args, **kwargs):
        return mutate(real(*args, **kwargs))

    with _patched(_sched, "schedule_for_transformed", faulty):
        yield


def nan_schedule_payload(value: float = np.nan):
    """Every schedule compiled inside the context carries a non-finite
    payload (poison_schedule), so device solves produce NaN/Inf output."""
    return _schedule_fault(lambda s: poison_schedule(s, value))


def wrong_schedule_values(factor: float = 2.0):
    """Every schedule compiled inside the context is finitely WRONG
    (scale_schedule) — the solve succeeds, finiteness checks pass, and
    only a residual check against the original matrix can detect it."""
    return _schedule_fault(lambda s: scale_schedule(s, factor))


# -- refactorization faults ---------------------------------------------------


@contextlib.contextmanager
def corrupt_values_payload(value: float = np.nan):
    """Every schedule value-repack inside the context — the seam the
    `update_values` / `Preconditioner.refactor` fast path routes its
    numeric payload through, and on a card the values a device refresh of
    the SpTRSV kernel's packed tiles writes — returns a `value`-poisoned
    schedule, so solves through the updated operator emit non-finite
    output unless a health guard catches them.  Yields {"calls": n} for
    asserting the fault actually fired."""
    from ..solver import schedule as _sched
    real = _sched.repack_schedule_values
    count = {"calls": 0}

    def faulty(sched, new_data, new_diag):
        count["calls"] += 1
        return poison_schedule(real(sched, new_data, new_diag), value)

    with _patched(_sched, "repack_schedule_values", faulty):
        yield count



def pattern_drift(L):
    """A same-shape, same-nnz copy of a CSR with ONE strict-lower entry's
    column silently shifted left — the pattern drift that value-level
    checks cannot see (finiteness, norms and fingerprint length all
    match).  update_values / refactor must reject it with a typed
    PatternMismatchError, never produce a finite wrong answer."""
    from ..sparse.csr import CSR
    indices = L.indices.copy()
    rows = np.repeat(np.arange(L.n_rows), np.diff(L.indptr))
    for p in range(L.nnz):
        c, r = int(indices[p]), int(rows[p])
        if not 0 < c < r:               # need a shiftable strict-lower entry
            continue
        if p > 0 and rows[p - 1] == r and indices[p - 1] == c - 1:
            continue                    # (r, c-1) occupied: stay sorted/unique
        indices[p] = c - 1
        return CSR(indptr=L.indptr, indices=indices, data=L.data.copy(),
                   shape=L.shape)
    raise ValueError("pattern_drift: no shiftable strict-lower entry "
                     "(matrix too small/diagonal)")

# -- static schedule defects --------------------------------------------------
#
# Each pure mutator manufactures one class of structurally-broken-but-
# plausible artifact: shapes, dtypes and engine lowering all stay valid,
# so WITHOUT the static verifier the defect surfaces as a finite wrong
# answer at solve time on the plain path, or as an untyped error from the
# SpTRSV kernel's packing on a card.  The tests prove
# `repro_torch.analysis.verify` rejects every class with a typed error
# naming the check/step/lane BEFORE anything executes.


def swap_schedule_steps(sched, a: int = 0, b: int | None = None):
    """A copy of a LevelSchedule with steps `a` and `b` (default: last)
    exchanged in every width group — the classic scheduling race: work
    that depended on step `a` now runs before it."""
    S = sched.num_steps
    b = S - 1 if b is None else b
    if S < 2 or a == b:
        raise ValueError(f"need two distinct steps to swap, have {S}")

    def swap(arr):
        if arr is None:
            return None
        out = arr.copy()
        out[[a, b]] = out[[b, a]]
        return out

    groups = tuple(
        dataclasses.replace(g, row_ids=swap(g.row_ids),
                            dep_idx=swap(g.dep_idx),
                            dep_coef=swap(g.dep_coef), dinv=swap(g.dinv),
                            carry_in=swap(g.carry_in),
                            carry_out=swap(g.carry_out))
        for g in sched.groups)
    return dataclasses.replace(sched, groups=groups)


def duplicate_schedule_row(sched):
    """A copy in which one finalized row is finalized AGAIN on a padding
    lane of a later step — the double-commit defect (lane/row bijection
    broken; last writer wins at runtime, so the answer can still be
    finite)."""
    n = sched.n
    sink = sched.n_carry + 1
    for gi, g in enumerate(sched.groups):
        fin = g.row_ids != n
        if g.carry_out is not None:
            fin &= g.carry_out == sink      # don't also duplicate a carry
        for s in range(g.row_ids.shape[0]):
            src = np.flatnonzero(fin[s])
            pad = np.flatnonzero(g.row_ids[s] == n)
            if src.size and pad.size:
                c_src, c_dst = int(src[0]), int(pad[0])
                row_ids = g.row_ids.copy()
                dinv = g.dinv.copy()
                row_ids[s, c_dst] = row_ids[s, c_src]
                dinv[s, c_dst] = dinv[s, c_src]
                groups = list(sched.groups)
                groups[gi] = dataclasses.replace(g, row_ids=row_ids,
                                                 dinv=dinv)
                return dataclasses.replace(sched, groups=tuple(groups))
    raise ValueError("duplicate_schedule_row: no (final lane, padding "
                     "lane) pair in any step")


def oob_schedule_index(sched, offset: int = 7):
    """A copy with ONE live ELL dependency slot's gather index pushed past
    the x-buffer (n + offset) — an out-of-bounds read: the plain path's
    gather raises, and the SpTRSV kernel would read outside x."""
    n = sched.n
    for gi, g in enumerate(sched.groups):
        live = g.row_ids != n
        if g.carry_out is not None:
            live |= g.carry_out != sched.n_carry + 1
        hot = np.argwhere((g.dep_coef != 0) & live[..., None])
        if hot.size:
            s, c, d = (int(v) for v in hot[0])
            dep_idx = g.dep_idx.copy()
            dep_idx[s, c, d] = n + offset
            groups = list(sched.groups)
            groups[gi] = dataclasses.replace(g, dep_idx=dep_idx)
            return dataclasses.replace(sched, groups=tuple(groups))
    raise ValueError("oob_schedule_index: schedule has no live dependency "
                     "slots (diagonal system?)")


def corrupt_plan(ts, mode: str = "target"):
    """A copy of a TransformedSystem whose ReplayPlan is corrupt:

    mode "target" — the first commit's target level is pushed to (or past)
                    the row's own level, so replaying it would rewrite a
                    row with its own not-yet-eliminated dependencies;
         "row"    — the first commit names a row outside [0, n).
    A plan with no commits gains one bogus out-of-range commit either way.
    """
    from .transform import ReplayPlan
    plan = ts.plan
    if plan is None:
        raise ValueError("corrupt_plan: system carries no ReplayPlan")
    n = int(plan.level_of0.shape[0])
    commits = list(plan.commits)
    if not commits:
        commits = [(n + 3, 0)]
    elif mode == "target":
        row, _ = commits[0]
        commits[0] = (row, int(plan.level_of0[row]) + 1)
    elif mode == "row":
        _, target = commits[0]
        commits[0] = (n + 3, target)
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    bad = ReplayPlan(level_of0=plan.level_of0, commits=tuple(commits))
    return dataclasses.replace(ts, plan=bad)


@contextlib.contextmanager
def _counted_schedule_fault(mutate):
    """Like _schedule_fault, but yields {"calls": n} and tolerates
    schedules the mutator cannot corrupt (too small: passed through)."""
    from ..solver import schedule as _sched
    real = _sched.schedule_for_transformed
    count = {"calls": 0}

    def faulty(*args, **kwargs):
        sched = real(*args, **kwargs)
        try:
            sched = mutate(sched)
            count["calls"] += 1
        except ValueError:      # nothing to corrupt in this schedule
            pass
        return sched

    with _patched(_sched, "schedule_for_transformed", faulty):
        yield count


def reorder_schedule_step(a: int = 0, b: int | None = None):
    """Every schedule compiled inside the context has steps `a` and `b`
    swapped (swap_schedule_steps) — a scheduling race the static verifier
    must reject as check="race" before a solve can run.  Yields
    {"calls": n}."""
    return _counted_schedule_fault(lambda s: swap_schedule_steps(s, a, b))


def duplicate_lane_row():
    """Every schedule compiled inside the context finalizes one row twice
    (duplicate_schedule_row) — rejected as check="bijection".  Yields
    {"calls": n}."""
    return _counted_schedule_fault(duplicate_schedule_row)


def oob_ell_index(offset: int = 7):
    """Every schedule compiled inside the context carries one live
    out-of-bounds ELL gather (oob_schedule_index) — rejected as
    check="index-bounds".  Yields {"calls": n}."""
    return _counted_schedule_fault(lambda s: oob_schedule_index(s, offset))


@contextlib.contextmanager
def corrupt_replay_plan(mode: str = "target"):
    """Every transform built inside the context exports a corrupt
    ReplayPlan (corrupt_plan) — the transform auditor must reject it as
    check="replay-bounds" before update_values can replay it.  Yields
    {"calls": n}."""
    # the package re-exports the transform FUNCTION under the submodule's
    # name, so `from . import transform` would grab the function
    _tr = importlib.import_module(".transform", __package__)
    real = _tr.transform
    count = {"calls": 0}

    def faulty(*args, **kwargs):
        count["calls"] += 1
        return corrupt_plan(real(*args, **kwargs), mode=mode)

    with _patched(_tr, "transform", faulty):
        yield count


# -- cache faults -------------------------------------------------------------


def corrupt_cache_entries(cache_dir, mode: str = "garbage") -> list:
    """Corrupt every operator artifact of the port (`torch-op-*.pkl`)
    under `cache_dir` in place.

    mode: "garbage"  — non-pickle bytes (torn write from a crashed
                       process without atomic replace),
          "truncate" — valid pickle prefix cut short (partial write),
          "stale"    — a well-formed pickle whose version field is not
                       CACHE_VERSION.
    Returns the corrupted paths.
    """
    from ..solver.operator import CACHE_PREFIX
    paths = sorted(Path(cache_dir).glob(f"{CACHE_PREFIX}*.pkl"))
    for p in paths:
        if mode == "garbage":
            p.write_bytes(b"\x80\x05this is not a valid pickle stream")
        elif mode == "truncate":
            raw = p.read_bytes()
            p.write_bytes(raw[: max(1, len(raw) // 3)])
        elif mode == "stale":
            payload = pickle.loads(p.read_bytes())
            payload["version"] = -1
            p.write_bytes(pickle.dumps(payload))
        else:
            raise ValueError(f"unknown corruption mode {mode!r}")
    return paths


# -- engine faults ------------------------------------------------------------


@contextlib.contextmanager
def fail_engine_compile(name: str, times: int | None = None, exc=None):
    """The named REGISTERED engine's compile() raises for the first
    `times` calls inside the context (None = every call).  Yields a
    counter dict: {"calls": total compile calls, "failed": injected
    failures} for asserting the fault actually fired.  An operator built
    on a card inside the context memoizes the failure at its build (which
    stages the kernel's schedule), so its solves refuse the engine."""
    from ..solver.engines import get_engine
    eng = get_engine(name)
    real = eng.compile                  # bound method of the live instance
    count = {"calls": 0, "failed": 0}

    def faulty(dsched):
        count["calls"] += 1
        if times is None or count["calls"] <= times:
            count["failed"] += 1
            raise (exc if exc is not None else RuntimeError(
                f"injected compile failure in engine {name!r} "
                f"(call {count['calls']})"))
        return real(dsched)

    with _patched(eng, "compile", faulty):
        yield count


@contextlib.contextmanager
def engine_unavailable(name: str):
    """The named registered engine reports available() == False inside the
    context (e.g. "no CUDA device in this process")."""
    from ..solver.engines import get_engine
    eng = get_engine(name)
    with _patched(eng, "available", lambda: False):
        yield


# -- tuner faults -------------------------------------------------------------


@contextlib.contextmanager
def fail_tuner(exc=None):
    """Every `StrategyPortfolio.tune` call inside the context raises — the
    fault class a serving tier's BACKGROUND tuning worker must survive:
    admission already served the untuned operator, so a tuner blow-up may
    degrade the entry (no hot-swap, `TunerFailureWarning`) but must never
    poison it or block the request path.  Yields {"calls": n} for
    asserting the fault actually fired."""
    from .portfolio import StrategyPortfolio
    count = {"calls": 0}

    def faulty(self, L):
        count["calls"] += 1
        raise (exc if exc is not None else RuntimeError(
            f"injected tuner failure (call {count['calls']})"))

    with _patched(StrategyPortfolio, "tune", faulty):
        yield count


@contextlib.contextmanager
def slow_tuner(delay_s: float = 0.5):
    """Every `StrategyPortfolio.tune` call inside the context stalls for
    `delay_s` before running for real — the stalled-background-tuner fault:
    entries stay "warming" while requests keep flowing through the untuned
    operator, and the eventual hot-swap still lands.  Yields {"calls": n}."""
    import time
    from .portfolio import StrategyPortfolio
    real = StrategyPortfolio.tune
    count = {"calls": 0}

    def slow(self, L):
        count["calls"] += 1
        time.sleep(delay_s)
        return real(self, L)

    with _patched(StrategyPortfolio, "tune", slow):
        yield count


# -- profiler faults ----------------------------------------------------------


def slow_step(step_idx: int, seconds: float):
    """Every TIMED (non-warmup) pass of the step-wise profiler
    (`repro_torch.obs.profile`, the plain engine one step at a time)
    inside the context stalls for `seconds` before executing step
    `step_idx` — the one-slow-step fault (a preempted core) the per-step
    histogram must localize: `argmax(step_ms) == step_idx`.  The card's
    stamped profile is one launch of K1's stamped form, whose steps run
    inside the kernel, so no host stall can land inside one of them: this
    fault does not reach it."""
    from ..obs import profile as _prof
    return _patched(_prof, "_STEP_FAULT", (int(step_idx), float(seconds)))


# -- mesh faults --------------------------------------------------------------


@contextlib.contextmanager
def lose_mesh(exc=None):
    """Sharded lowering fails as if the mesh's devices were lost: every
    `solver.distributed.lower_sharded` call inside the context raises.
    Schedules the sharded engine lowered BEFORE the fault keep their
    memoized callables — a real device loss also only breaks new work,
    which is exactly what the fallback chain must cover (K1 on a card,
    the plain body on the CPU)."""
    from ..solver import distributed as _dist

    def faulty(*args, **kwargs):
        raise (exc if exc is not None else RuntimeError(
            "injected mesh device loss: sharded lowering unavailable"))

    with _patched(_dist, "lower_sharded", faulty):
        yield


@contextlib.contextmanager
def fail_sharded_step(step: int = 0, times: int | None = 1, exc=None,
                      stage: str = "step"):
    """This rank's sharded sweeps raise at schedule step `step` (the first
    `times` sweeps that reach it inside the context; None: all of them),
    as a launch or an out-of-memory in a step would: in the step's local
    work (`stage="step"`) or in the scatter of what its all_gathers
    brought (`stage="publish"`).  Arm it on one rank only: the others
    still finish the sweep, and every rank raises the same
    `ShardedCallError` naming this one.  The lowering stays memoized, so
    the next call runs."""
    from ..solver import distributed as _dist
    if stage not in ("step", "publish"):
        raise ValueError(f"stage must be step|publish, got {stage!r}")
    left = [times]

    def fault(s: int, at: str) -> None:
        if s != step or at != stage or left[0] == 0:
            return
        if left[0] is not None:
            left[0] -= 1
        raise (exc if exc is not None else RuntimeError(
            f"injected failure of sharded step {step} ({stage}) on this "
            f"rank"))

    with _patched(_dist, "_STEP_FAULT", fault):
        yield


@contextlib.contextmanager
def fail_measurement():
    """This rank's first composed sweep inside the context raises before
    its first allocation, as an out-of-memory would; around a measured
    build that is the first candidate's (the tuner's `measure_top_k`) or
    the first pair's (the preconditioner's) warm-up.  Arm it on one rank
    only: under a mesh that rank hands the failure to the sweep's sharded
    call, and every rank raises the same `ShardedCallError` naming it; on
    one device the failure raises (a measurement that fails on the card
    is never scored as slow)."""
    from ..solver import operator as _operator
    left = [1]

    def fault() -> None:
        if left[0]:
            left[0] = 0
            raise RuntimeError("injected out-of-memory in a sweep on this "
                               "rank")

    with _patched(_operator, "_SWEEP_FAULT", fault):
        yield
