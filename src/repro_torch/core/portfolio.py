"""Strategy-portfolio auto-tuner: pick the best transform per matrix.

Port of `repro.core.portfolio`.  A `StrategyPortfolio` enumerates
candidate strategies (the four shipped ones plus parameter sweeps), runs
the full transform + schedule compile for each, scores every candidate
with an analytic per-solve cost model, and returns a ranked
`PortfolioReport`; `tune_pair` picks one strategy for a preconditioner's
two sweeps.

Cost model (per solve, microseconds; all constants calibratable):

    main     = steps * step_overhead_us
             + padded_flops * us_per_padded_flop
             + memory_bytes * us_per_byte
    preamble = nnz_T * us_per_preamble_nnz
             + preamble_steps * us_per_preamble_step
    launches = launches * us_per_launch
    total    = main + preamble + launches
             (+ barriers * collective_latency_us; barriers = steps, or
                the sharded engine's steps + preamble_steps)

What a step is, and which flops and bytes a sweep moves, is the serving
engine's to say (`Engine.sweep_shape`): the plain "torch" engine runs the
schedule's steps over its padded width groups (the reference's counts);
the CUDA kernel runs the DAG's levels over the packed rows, for the main
system and the T-factor preamble's, two launches each (the free first
level and the tiles).  The preamble-step and launch terms are the port's;
they default to zero, so under the reference's four constants the port
ranks as the reference does.

Constants are the port's own, fitted by `CostModel.calibrate` from its
per-step profiler (`repro_torch.obs.profile`; `python -m
repro_torch.obs.calibrate`), never the reference's TPU or CPU presets.
`CostModel()` holds the H100's per-step constants, and
`default_cost_model_for(engine)` the whole model for an engine: the
card's for "cuda", the CPU's for "torch".

Measured mode (`measure_top_k > 0`) times the model's top-k candidates as
`TriangularOperator.device_solve_fn` serves them (device preamble
included; wall time around work that ends in a synchronize, minimum over
reps) and re-ranks them.  A candidate whose transform or schedule compile
raises on the host is reported as failed; a failure on the card raises.

`tune` opens the reference's `portfolio.tune` span and counts
`portfolio_tunes`, `portfolio_candidate_failures` and
`portfolio_measure_notes` in `repro_torch.obs.default_registry()`.

Under a sharded engine (`mesh=`) every step of the schedule and of its
preamble is one all_gather family, so `CostModel.sharded()` charges each
of them `collective_latency_us` (the engine's sweep shape counts them as
`"barriers"`), and `default_cost_model_for` returns it for a sharded
engine: its base is the CPU's constants on a CPU mesh and the sharded
path's measured step on a CUDA mesh, each charging a preamble step as a
main one.  Its sweep shape is the padded schedule's.  Measured mode
under a mesh of more than one rank times on every rank, and the axis'
first rank decides: its samples, its stop at the deadline and its
outlier re-measurement are broadcast (`solver.distributed.agree`), so
every rank ranks the same candidates the same way and builds the same
schedule.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..obs import trace as _obs
from ..obs.metrics import default_registry as _default_registry
from ..sparse.csr import CSR
from .strategies import (AvgLevelCost, ConstrainedAvgLevelCost,
                         CriticalPathRewrite, ManualEveryK, NoRewrite,
                         Strategy, strategy_label)
from .transform import TransformMetrics, TransformedSystem, transform

__all__ = ["CostModel", "PortfolioCandidate", "PortfolioReport",
           "PairReport", "StrategyPortfolio", "default_candidates",
           "default_cost_model_for", "make_strategy", "STRATEGY_REGISTRY",
           "CUDA_COST_MODEL", "CPU_COST_MODEL"]

# stable strategy name -> zero-arg-constructible class (docs/strategies.md)
STRATEGY_REGISTRY = {
    "no_rewriting": NoRewrite,
    "avgLevelCost": AvgLevelCost,
    "manual_every_k": ManualEveryK,
    "constrained_avg": ConstrainedAvgLevelCost,
    "critical_path": CriticalPathRewrite,
}


def make_strategy(spec) -> Strategy:
    """Resolve a strategy spec: a Strategy instance passes through, a stable
    name string (see STRATEGY_REGISTRY) constructs the default instance."""
    if isinstance(spec, str):
        try:
            return STRATEGY_REGISTRY[spec]()
        except KeyError:
            raise ValueError(
                f"unknown strategy {spec!r}; expected one of "
                f"{sorted(STRATEGY_REGISTRY)} or a Strategy instance") from None
    if not hasattr(spec, "apply"):
        raise TypeError(f"not a Strategy: {spec!r}")
    return spec


# The H100's constants, fitted by chip_smoke.py phase 6 (`calibrate` over
# K1's stamped per-step profiles of lung2_like(1.0) and torso2_like(1.0),
# no_rewriting) on an NVIDIA H100 80GB HBM3, 700.00 W.  The launch charge
# is the host's time to enqueue a served K1 call, per launch: it depends on
# the host (39.8 and 61.1 us in two runs on that card).
H100_STEP_US = 0.32513451
H100_US_PER_FLOP = 3.0240848e-05
H100_US_PER_BYTE = 3.6062861e-05
H100_LAUNCH_US = 61.055538
# The CPU's constants, fitted by `python -m repro_torch.obs.calibrate
# --device cpu --scale 0.25 --matrices lung2_like` (the plain engine's
# stepwise profile, one torch thread; 27.03 and 27.43 us in two runs):
# CPU numbers, not the card's.
CPU_STEP_US = 27.03
CPU_US_PER_FLOP = 0.0
CPU_US_PER_BYTE = 0.0
# The sharded path's compute a step on the H100 (ShardedEngine on a CUDA
# mesh: the plain step body's torch launches, host-bound), from
# chip_smoke.py phase 11 on an NVIDIA H100 80GB HBM3, 700.00 W, an NCCL
# world of one: lung2_like(1.0) no_rewriting's median profiled step
# (286.386 us) less its median collective (125.297 us).  Its flops and
# bytes a step cost nothing measurable beside that.
H100_SHARDED_STEP_US = 161.088


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Calibratable constants of the analytic per-solve cost (microseconds).

    The defaults are the H100's per-step constants (module doc) with the
    preamble charged by nothing; `default_cost_model_for` adds the terms
    the serving engine pays.  `us_per_preamble_step` charges each step of
    the T-factor preamble's own schedule, `us_per_launch` each launch of a
    sweep (host time), `collective_latency_us` each barrier of a sharded
    sweep (`sharded()`): one a step of the schedule and, where the
    engine's sweep shape counts them (`"barriers"`), of its preamble's.
    """

    step_overhead_us: float = H100_STEP_US
    us_per_padded_flop: float = H100_US_PER_FLOP
    us_per_byte: float = H100_US_PER_BYTE
    us_per_preamble_nnz: float = 0.0
    collective_latency_us: float = 0.0
    us_per_preamble_step: float = 0.0
    us_per_launch: float = 0.0

    @classmethod
    def sharded(cls, collective_latency_us: float = 5.0,
                base: "CostModel | None" = None) -> "CostModel":
        """`base` (default: `CostModel()`, the card's per-step constants)
        plus a per-barrier collective charge: the model for ShardedEngine
        serving, where every schedule step is one synchronization barrier
        across the mesh.  The 5 us default is the reference's; calibrate
        it for the fabric (`calibrate` on a profile with a collective
        split).  `default_cost_model_for` gives a sharded engine this
        over the sharded path's own per-step constants."""
        return dataclasses.replace(
            base if base is not None else cls(),
            collective_latency_us=collective_latency_us)

    def calibrate(self, profile) -> "CostModel":
        """Refit the per-step constants from a measured `ScheduleProfile`
        (repro_torch.obs.profile) and return the calibrated model.

        Least-squares of per-step time against per-step padded FLOPs and
        bytes, intercept -> `step_overhead_us`, as the reference does:

        * when the profile carries a collective split (sharded engines),
          the fit runs on COMPUTE time and `collective_latency_us` is set
          to the median per-step collective time;
        * constant columns are excluded from the fit, their charge (at the
          model's existing rate) is subtracted out of the intercept, and
          the residual becomes the overhead — so `predict()` with the
          calibrated model still reproduces the fitted per-step time.

        The port sets its two terms too.  The preamble runs the same
        engine: on the card (`profile.engine == "cuda"`) its rows and deps
        are charged with the main's, so a preamble step adds the fitted
        overhead, and the profile's measured host time per launch
        (`launch_us`) becomes `us_per_launch`; on the plain engine, whose
        counts are the main schedule's alone, a preamble step costs the
        profile's mean fitted step.
        """
        t_us = np.asarray(profile.step_ms, dtype=float) * 1e3
        if t_us.size == 0:
            return self
        updates: dict = {}
        coll = getattr(profile, "collective_ms", None)
        if coll is not None:
            coll_us = np.asarray(coll, dtype=float) * 1e3
            t_us = np.maximum(t_us - coll_us, 0.0)
            updates["collective_latency_us"] = float(np.median(coll_us))
        feats = [
            ("us_per_padded_flop",
             np.asarray(profile.step_padded_flops, dtype=float)),
            ("us_per_byte", np.asarray(profile.step_bytes, dtype=float)),
        ]
        included, excluded = [], []
        for name, col in feats:
            scale = max(1.0, float(np.abs(col).mean()))
            (included if float(col.std()) > 1e-9 * scale
             else excluded).append((name, col))
        design = np.column_stack(
            [np.ones_like(t_us)] + [col for _, col in included])
        coef, *_ = np.linalg.lstsq(design, t_us, rcond=None)
        coef = np.maximum(coef, 0.0)
        overhead = float(coef[0])
        for (name, _), v in zip(included, coef[1:]):
            updates[name] = float(v)
        for name, col in excluded:
            overhead -= getattr(self, name) * float(col.mean())
        updates["step_overhead_us"] = max(0.0, overhead)
        fitted = dataclasses.replace(self, **updates)
        if getattr(profile, "engine", "") == "cuda":
            # the card's sweep counts the preamble's rows and deps with the
            # main's (CudaEngine.sweep_shape): a preamble step adds the
            # overhead, and the host's time per launch is measured
            updates["us_per_preamble_step"] = fitted.step_overhead_us
            if getattr(profile, "launch_us", None) is not None:
                updates["us_per_launch"] = float(profile.launch_us)
        else:
            # the plain engine's counts are the main schedule's alone: a
            # preamble step costs a profiled step on average
            updates["us_per_preamble_step"] = float(np.mean(
                fitted.step_overhead_us
                + np.asarray(profile.step_padded_flops, dtype=float)
                * fitted.us_per_padded_flop
                + np.asarray(profile.step_bytes, dtype=float)
                * fitted.us_per_byte))
        return dataclasses.replace(self, **updates)

    def predict(self, sched, metrics: TransformMetrics,
                shape: dict | None = None) -> dict:
        """Cost breakdown (us) for one compiled schedule + its transform.

        `shape` is the serving engine's `sweep_shape(ts, sched)`; None
        counts the schedule as the reference does, with no preamble steps
        and no launches."""
        if shape is None:
            shape = {"steps": sched.num_steps,
                     "padded_flops": sched.padded_flops(),
                     "memory_bytes": sched.memory_bytes(),
                     "preamble_steps": 0, "launches": 0}
        steps_us = shape["steps"] * self.step_overhead_us
        flops_us = shape["padded_flops"] * self.us_per_padded_flop
        bytes_us = shape["memory_bytes"] * self.us_per_byte
        pre_us = metrics.nnz_T * self.us_per_preamble_nnz + \
            shape["preamble_steps"] * self.us_per_preamble_step
        # the sharded engine's shape counts its preamble's barriers too;
        # any other is charged the reference's way, one a main step
        coll_us = shape.get("barriers", shape["steps"]) * \
            self.collective_latency_us
        launch_us = shape["launches"] * self.us_per_launch
        return {
            "steps_us": steps_us, "flops_us": flops_us,
            "bytes_us": bytes_us, "preamble_us": pre_us,
            "collectives_us": coll_us, "launches_us": launch_us,
            "total_us": (steps_us + flops_us + bytes_us + pre_us + coll_us
                         + launch_us),
        }


CUDA_COST_MODEL = CostModel(us_per_preamble_step=H100_STEP_US,
                            us_per_launch=H100_LAUNCH_US)
CPU_COST_MODEL = CostModel(step_overhead_us=CPU_STEP_US,
                           us_per_padded_flop=CPU_US_PER_FLOP,
                           us_per_byte=CPU_US_PER_BYTE,
                           us_per_preamble_step=CPU_STEP_US)
# the base of a sharded engine's model on a CUDA mesh: every step of the
# schedule and of its preamble runs the same step body
SHARDED_CUDA_BASE = CostModel(step_overhead_us=H100_SHARDED_STEP_US,
                              us_per_padded_flop=0.0, us_per_byte=0.0,
                              us_per_preamble_step=H100_SHARDED_STEP_US)


def default_cost_model_for(engine) -> CostModel:
    """The auto-tune cost model an engine implies when the caller passes
    none: `CostModel.sharded()` for a sharded engine, over the CPU's
    constants on a CPU mesh and the sharded path's on a CUDA mesh (both
    charge the preamble's steps as the main schedule's), the card's
    constants for "cuda", the CPU's for
    "torch" (`CostModel()` for an engine the port has no constants for).
    The ONE definition both facades (`TriangularOperator.from_csr` and
    `Preconditioner._pair_decision`) consult, so operator-level and
    pair-level tuning rank with the same objective."""
    from ..solver.engines import ShardedEngine
    if isinstance(engine, ShardedEngine):
        cpu = engine.resolve_mesh().device_type == "cpu"
        return CostModel.sharded(
            base=CPU_COST_MODEL if cpu else SHARDED_CUDA_BASE)
    name = engine if isinstance(engine, str) else getattr(engine, "name",
                                                          None)
    if name == "cuda":
        return CUDA_COST_MODEL
    if name == "torch":
        return CPU_COST_MODEL
    return CostModel()


@dataclasses.dataclass
class PortfolioCandidate:
    """One scored (strategy, transform, schedule) triple.

    `steps`, `padded_flops` and `memory_bytes` are the serving engine's
    counts (`Engine.sweep_shape`), `preamble_steps` and `launches` too.
    `ts`/`sched`/`strategy` are dropped by `slim()`."""

    label: str
    predicted_us: float
    breakdown: dict
    steps: int
    num_levels: int
    padded_flops: int
    memory_bytes: int
    nnz_T: int
    preamble_steps: int = 0
    launches: int = 0
    metrics: TransformMetrics | None = None
    measured_us: float | None = None
    error: str | None = None
    measure_note: str | None = None     # timeout / outlier detail
    strategy: Strategy | None = None
    ts: TransformedSystem | None = None
    sched: object | None = None

    def slim(self) -> "PortfolioCandidate":
        return dataclasses.replace(self, strategy=None, ts=None, sched=None)


@dataclasses.dataclass
class PortfolioReport:
    """Ranked tuner output: candidates[0] is the pick."""

    matrix: dict
    candidates: list
    cost_model: CostModel
    measured_top_k: int
    tune_ms: float
    engine: str = ""

    @property
    def best(self) -> PortfolioCandidate:
        return self.candidates[0]

    def slim(self) -> "PortfolioReport":
        return dataclasses.replace(
            self, candidates=[c.slim() for c in self.candidates])

    def to_dict(self) -> dict:
        return {
            "matrix": self.matrix,
            "engine": self.engine,
            "cost_model": dataclasses.asdict(self.cost_model),
            "measured_top_k": self.measured_top_k,
            "tune_ms": round(self.tune_ms, 2),
            "candidates": [{
                "rank": i, "label": c.label,
                "predicted_us": (None if not np.isfinite(c.predicted_us)
                                 else round(c.predicted_us, 1)),
                "measured_us": (None if c.measured_us is None
                                else round(c.measured_us, 1)),
                "steps": c.steps, "levels": c.num_levels,
                "preamble_steps": c.preamble_steps,
                "launches": c.launches,
                "padded_flops": c.padded_flops,
                "memory_bytes": c.memory_bytes, "nnz_T": c.nnz_T,
                "breakdown": {k: round(v, 2) for k, v in c.breakdown.items()},
                "error": c.error,
                "measure_note": c.measure_note,
            } for i, c in enumerate(self.candidates)],
        }

    def table(self) -> str:
        """Human-readable ranked table."""
        hdr = (f"{'rank':>4}  {'strategy':<42} {'pred_us':>10} "
               f"{'meas_us':>10} {'steps':>6} {'pre':>5} {'levels':>6} "
               f"{'padded_flops':>12} {'nnz_T':>8}")
        lines = [hdr, "-" * len(hdr)]
        for i, c in enumerate(self.candidates):
            meas = f"{c.measured_us:10.1f}" if c.measured_us is not None \
                else f"{'-':>10}"
            if c.error is not None:
                lines.append(f"{i:>4}  {c.label:<42} {'FAILED':>10} "
                             f"{'-':>10}  {c.error[:40]}")
                continue
            lines.append(f"{i:>4}  {c.label:<42} {c.predicted_us:10.1f} "
                         f"{meas} {c.steps:>6} {c.preamble_steps:>5} "
                         f"{c.num_levels:>6} {c.padded_flops:>12} "
                         f"{c.nnz_T:>8}")
        return "\n".join(lines)


@dataclasses.dataclass
class PairReport:
    """Joint tuning decision for a forward/backward triangular-operator pair.

    A preconditioner application M^-1 r is TWO sweeps back to back (L then
    L^T, or L then U), and the strategy is chosen ONCE for the pair: per
    candidate label, the pair cost is the sum of the per-side costs, and
    `best_label` minimizes that sum.  Labels measured on BOTH sides rank
    first by measured sum; the rest follow by predicted sum (never
    interleaved: wall-clock and model cost are different scales).
    """

    fwd: PortfolioReport
    bwd: PortfolioReport
    combined: list                  # [{label, fwd_us, bwd_us, total_us,
    #                                  measured}] ranked, [0] is the pick
    best_label: str

    @property
    def tune_ms(self) -> float:
        return self.fwd.tune_ms + self.bwd.tune_ms

    def slim(self) -> "PairReport":
        return dataclasses.replace(self, fwd=self.fwd.slim(),
                                   bwd=self.bwd.slim())

    def to_dict(self) -> dict:
        return {
            "best_label": self.best_label,
            "combined": self.combined,
            "fwd": self.fwd.to_dict(),
            "bwd": self.bwd.to_dict(),
        }

    def table(self) -> str:
        hdr = (f"{'rank':>4}  {'strategy':<42} {'fwd_us':>10} "
               f"{'bwd_us':>10} {'pair_us':>10} {'scored':>9}")
        lines = [hdr, "-" * len(hdr)]
        for i, c in enumerate(self.combined):
            lines.append(f"{i:>4}  {c['label']:<42} {c['fwd_us']:>10.1f} "
                         f"{c['bwd_us']:>10.1f} {c['total_us']:>10.1f} "
                         f"{'measured' if c['measured'] else 'model':>9}")
        return "\n".join(lines)


def default_candidates() -> list:
    """The shipped portfolio: the four strategies plus parameter sweeps over
    ManualEveryK / ConstrainedAvgLevelCost / CriticalPathRewrite."""
    return [
        NoRewrite(),
        AvgLevelCost(),
        ManualEveryK(k=5),
        ManualEveryK(k=10),
        ManualEveryK(k=20),
        ConstrainedAvgLevelCost(),                          # a=8, b=64
        ConstrainedAvgLevelCost(alpha=16, beta=128),
        ConstrainedAvgLevelCost(alpha=4, beta=32),
        CriticalPathRewrite(beta=8),
        CriticalPathRewrite(beta=32),
    ]


def _synchronize(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StrategyPortfolio:
    """Enumerate -> transform -> compile -> score -> rank.

    candidates:     Strategy instances to try (default_candidates() if None).
    cost_model:     CostModel constants (None: default_cost_model_for the
                    engine).
    chunk/max_deps/dtype: schedule-compiler configuration, forwarded to
                    schedule_for_transformed.
    measure_top_k:  if > 0, time the k model-best candidates as the engine
                    serves them (module doc) and re-rank those.
    measure_iters:  timing repetitions per measured candidate.
    measure_timeout_s: wall-clock budget per measured candidate — sampling
                    stops at the deadline and whatever was collected
                    decides.
    measure_outlier_ratio: when the samples of one candidate disagree by
                    more than this factor, the candidate is re-measured once
                    and the samples pooled; the recorded time is the pooled
                    minimum.  What happened is recorded on the candidate's
                    `measure_note`.
    engine:         the serving engine — a registered name, an Engine, or
                    None for the device's default ("cuda" on a card,
                    "torch" on the CPU).  It says what a step costs
                    (`Engine.sweep_shape`) and runs the measured mode.
    device:         where measured mode runs: "cuda" (the default when
                    None) or "cpu".
    """

    def __init__(self, candidates=None, cost_model: CostModel | None = None,
                 chunk: int = 256, max_deps: int = 16, dtype=np.float32,
                 measure_top_k: int = 0, measure_iters: int = 3,
                 measure_timeout_s: float = 10.0,
                 measure_outlier_ratio: float = 4.0,
                 engine=None, device=None):
        from ..solver.engines import resolve_engine
        self.candidates = (default_candidates() if candidates is None
                           else list(candidates))
        self.chunk, self.max_deps, self.dtype = chunk, max_deps, dtype
        self.measure_top_k = measure_top_k
        self.measure_iters = measure_iters
        self.measure_timeout_s = measure_timeout_s
        self.measure_outlier_ratio = measure_outlier_ratio
        self.device = device
        if engine is None:
            from ..solver.levelset import resolve_device
            engine = resolve_engine(None, device=resolve_device(device))
        self.engine = resolve_engine(engine)
        self.cost_model = cost_model if cost_model is not None else \
            default_cost_model_for(self.engine)

    def _compile(self, L: CSR, strat) -> tuple:
        """(ts, sched) of one candidate: its transform and schedule."""
        from ..solver.schedule import schedule_for_transformed
        ts = transform(L, strat, validate=False, codegen=False)
        return ts, schedule_for_transformed(ts, chunk=self.chunk,
                                            max_deps=self.max_deps,
                                            dtype=self.dtype)

    def tune(self, L: CSR) -> PortfolioReport:
        with _obs.span("portfolio.tune", n=L.n_rows,
                       candidates=len(self.candidates),
                       measure_top_k=self.measure_top_k) as sp:
            report = self._tune(L)
            sp.set(best=report.best.label, tune_ms=report.tune_ms)
        reg = _default_registry()
        with reg.lock:
            reg.counter("portfolio_tunes", "portfolio tuning runs").inc()
            failures = reg.counter(
                "portfolio_candidate_failures",
                "candidates whose transform/compile raised")
            notes = reg.counter(
                "portfolio_measure_notes",
                "measured-mode anomalies by kind "
                "(timeout|outliers|measure_failed)")
            for c in report.candidates:
                if c.error is not None:
                    failures.inc()
                if c.measure_note:     # a failed measurement raises here
                    notes.inc(kind="timeout" if c.measure_note.startswith(
                        "timeout") else "outliers")
        return report

    def _tune(self, L: CSR) -> PortfolioReport:
        t0 = time.perf_counter()
        scored: list[PortfolioCandidate] = []
        failed: list[PortfolioCandidate] = []
        for strat in self.candidates:
            label = strategy_label(strat)
            try:
                ts, sched = self._compile(L, strat)
                shape = self.engine.sweep_shape(ts, sched)
            except Exception as e:  # a candidate blowing up on the host
                failed.append(PortfolioCandidate(   # must not kill the run
                    label=label, predicted_us=float("inf"), breakdown={},
                    steps=-1, num_levels=-1, padded_flops=-1,
                    memory_bytes=-1, nnz_T=-1,
                    error=f"{type(e).__name__}: {e}"))
                continue
            bd = self.cost_model.predict(sched, ts.metrics, shape)
            scored.append(PortfolioCandidate(
                label=label, predicted_us=bd["total_us"], breakdown=bd,
                steps=shape["steps"], num_levels=ts.metrics.num_levels_after,
                padded_flops=shape["padded_flops"],
                memory_bytes=shape["memory_bytes"],
                nnz_T=ts.metrics.nnz_T,
                preamble_steps=shape["preamble_steps"],
                launches=shape["launches"], metrics=ts.metrics,
                strategy=strat, ts=ts, sched=sched))
        if not scored:
            raise RuntimeError("every portfolio candidate failed: " +
                               "; ".join(c.error or "" for c in failed))
        scored.sort(key=lambda c: c.predicted_us)
        if self.measure_top_k > 0:
            # re-rank WITHIN the model's top-k by measured wall time; the
            # top-k stay ahead of the rest by model rank (wall time and
            # model cost are different scales).  A failure on the device
            # raises: no candidate is parked behind a kernel that failed
            top = scored[:self.measure_top_k]
            for c in top:
                self._measure(c)
            top.sort(key=lambda c: c.measured_us)
            scored = top + scored[self.measure_top_k:]
        lv_before = scored[0].metrics.num_levels_before
        return PortfolioReport(
            matrix={"n": L.n_rows, "nnz": L.nnz, "levels": lv_before},
            candidates=scored + failed, cost_model=self.cost_model,
            measured_top_k=self.measure_top_k,
            tune_ms=(time.perf_counter() - t0) * 1e3,
            engine=self.engine.name)

    def tune_pair(self, fwd: CSR, bwd: CSR) -> PairReport:
        """Tune a forward/backward operator pair jointly (see PairReport).

        `fwd` and `bwd` are the two ORIENTED lower-triangular systems of a
        preconditioner's sweeps (`orient_lower` output for the L and
        L^T/U halves).  Each side runs the normal `tune()`; the pick
        minimizes the summed pair cost over labels that succeeded on both
        sides.
        """
        rf, rb = self.tune(fwd), self.tune(bwd)

        def _by_label(report):
            return {c.label: c for c in report.candidates if c.error is None}

        cf, cb = _by_label(rf), _by_label(rb)
        shared = [lbl for lbl in cf if lbl in cb]
        if not shared:
            raise RuntimeError("no strategy succeeded on both sides of the "
                               "operator pair")
        combined = []
        for lbl in shared:
            f, b = cf[lbl], cb[lbl]
            measured = f.measured_us is not None and b.measured_us is not None
            fwd_us = f.measured_us if measured else f.predicted_us
            bwd_us = b.measured_us if measured else b.predicted_us
            combined.append({"label": lbl, "fwd_us": round(fwd_us, 1),
                             "bwd_us": round(bwd_us, 1),
                             "total_us": round(fwd_us + bwd_us, 1),
                             "measured": measured})
        combined.sort(key=lambda c: (not c["measured"], c["total_us"]))
        return PairReport(fwd=rf, bwd=rb, combined=combined,
                          best_label=combined[0]["label"])

    def _measure(self, cand: PortfolioCandidate) -> float:
        """Per-sweep wall time of the candidate as `device_solve_fn` serves
        it (preamble schedule + main schedule through the engine, on the
        portfolio's device); sets `cand.measured_us` and, when something
        noteworthy happened, `cand.measure_note`.

        Sampling stops at the `measure_timeout_s` deadline, and a sample
        spread wider than `measure_outlier_ratio` triggers one
        re-measurement whose samples are pooled in.  The recorded time is
        the pooled MINIMUM (a rep can only be measured too slow).
        """
        import torch
        from ..solver.levelset import resolve_device, torch_dtype
        from ..solver.operator import candidate_sweep_fn
        dev = resolve_device(self.device)
        fn = candidate_sweep_fn(cand.ts, cand.sched, self.engine, dev)
        b = torch.as_tensor(
            np.random.default_rng(0).standard_normal(cand.ts.A.n_rows),
            dtype=torch_dtype(cand.sched.dtype), device=dev)
        fn(b)                                   # warm-up outside the timer
        _synchronize(dev)

        def sample_until(deadline: float) -> list:
            out = []
            for _ in range(self.measure_iters):
                t0 = time.perf_counter()
                fn(b)
                _synchronize(dev)
                out.append((time.perf_counter() - t0) * 1e6)
                if self.engine.agree(time.perf_counter() >= deadline):
                    break
            return out

        deadline = time.perf_counter() + self.measure_timeout_s
        samples = sample_until(deadline)
        note = None
        if len(samples) < self.measure_iters:
            note = (f"timeout: {len(samples)}/{self.measure_iters} reps "
                    f"within {self.measure_timeout_s:g}s")
        elif self.engine.agree(
                max(samples) > self.measure_outlier_ratio * min(samples)):
            spread = self.engine.agree(max(samples) / min(samples))
            samples += sample_until(
                time.perf_counter() + self.measure_timeout_s)
            note = (f"outliers (spread {spread:.1f}x > "
                    f"{self.measure_outlier_ratio:g}x): re-measured, "
                    f"{len(samples)} samples pooled")
        samples = self.engine.agree(samples)
        cand.measured_us = min(samples)
        cand.measure_note = note
        return cand.measured_us
