"""Solve-path health checks: the typed error taxonomy, `HealthPolicy` and
the `SolveGuard` that enforces it.

Copy of `repro.core.resilience` for the port, consumed by:

* `repro_torch.solver.operator.TriangularOperator.solve` (+ `sptrsv`,
  `Preconditioner.apply`): input/output health checks with
  raise / fallback / repair actions,
* `repro_torch.solver.engines`: engine fallback chains
  (`engine_fallbacks`), each downgrade warned and recorded in
  `OperatorStats`.  A CUDA-staged schedule's chain never holds the plain
  engine, so no fallback hides the kernel,
* `repro_torch.precond.factorize`: breakdown-shift retries via
  `RetryPolicy`,
* `repro_torch.solver.operator._disk_load/_disk_store`: quarantine of
  corrupt or stale entries (`CacheQuarantineWarning`).

Error taxonomy
==============
    ResilienceError(RuntimeError)
    ├── NumericalHealthError     non-finite / inaccurate solve data; carries
    │                            `.stage` ("input"|"output"|"residual"),
    │                            `.where`, and `.fallbacks` attempted
    ├── EngineFallbackError      every engine in a fallback chain failed;
    │                            carries `.attempts` [(engine, reason), ...]
    ├── PatternMismatchError     a value-only refactorization was handed a
    │                            matrix whose sparsity pattern differs from
    │                            the frozen one; carries `.where` and
    │                            `.detail`
    ├── AdmissionError           the solve service rejected a request (a
    │                            tenant's in-flight cap); carries
    │                            `.tenant`, `.depth`, `.limit`
    ├── ScheduleInvariantError   a compiled LevelSchedule, or the SpTRSV
    │                            kernel's packed form of one, failed static
    │                            verification (`repro_torch.analysis.verify`):
    │                            a scheduling race, a broken lane/row
    │                            bijection, an out-of-bounds index —
    │                            carries `.check`, `.step`, `.lane`,
    │                            `.group`
    └── TransformInvariantError  a TransformedSystem / ReplayPlan failed the
                                 transform audit (triangularity, level
                                 monotonicity, fill accounting, replay
                                 index bounds); carries `.check` and
                                 `.where`

Warning taxonomy
================
    ResilienceWarning(UserWarning)
    ├── EngineFallbackWarning    an engine was downgraded (never silent)
    ├── HealthRepairWarning      a health violation was repaired, or served
    │                            by the host reference solve
    ├── CacheQuarantineWarning   a disk-cache entry was unreadable or stale
    │                            and moved to `.bad/`
    └── TunerFailureWarning      a background tune failed; the untuned
                                 operator keeps serving

Health policy
=============
`HealthPolicy` is resolved per solve: an explicit `HealthPolicy` instance,
a named level (`"off" | "on" | "strict" | "repair" | "fallback"`), or
`None` for the `REPRO_HEALTH_CHECKS` environment default (same names;
unset means `"on"`).  `"on"` checks input/output finiteness and raises
typed errors; `"strict"` additionally checks the relative residual
against the original matrix and statically certifies compiled schedules,
and the SpTRSV kernel's packed forms of them, via
`repro_torch.analysis.verify` before anything launches; `"repair"` /
`"fallback"` recover instead of raising.  Only those two ever serve a
solve from the float64 host reference, and then always with a
`HealthRepairWarning`, and only for an operator staged on the CPU: on a
card the kernel serves the solve or it raises, under every policy.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

__all__ = ["ResilienceError", "NumericalHealthError", "EngineFallbackError",
           "PatternMismatchError", "AdmissionError",
           "ScheduleInvariantError", "TransformInvariantError",
           "ResilienceWarning", "EngineFallbackWarning",
           "HealthRepairWarning", "CacheQuarantineWarning",
           "TunerFailureWarning", "HealthPolicy",
           "SolveGuard", "resolve_health_policy", "RetryPolicy"]


# -- error taxonomy -----------------------------------------------------------


class ResilienceError(RuntimeError):
    """Base class for typed solve-path failures (module doc taxonomy)."""


class NumericalHealthError(ResilienceError):
    """A solve's data failed a health check.

    stage:     "input" (non-finite right-hand side), "output" (non-finite
               solution), or "residual" (finite but inaccurate solution).
    where:     the component that detected it (operator repr, facade name).
    fallbacks: recovery paths attempted before raising (empty when the
               policy action is "raise").
    """

    def __init__(self, message: str, *, stage: str, where: str = "",
                 fallbacks: tuple = ()):
        self.stage = stage
        self.where = where
        self.fallbacks = tuple(fallbacks)
        tail = f" (attempted fallbacks: {list(self.fallbacks)})" \
            if self.fallbacks else ""
        super().__init__(f"[{stage}] {message}{tail}")


class EngineFallbackError(ResilienceError):
    """Every engine in a fallback chain failed to compile or solve.

    attempts: [(engine_name, reason), ...] in the order they were tried —
    the error message names each one, so the failure is actionable.
    """

    def __init__(self, where: str, attempts: list):
        self.where = where
        self.attempts = list(attempts)
        detail = "; ".join(f"{name}: {reason}" for name, reason in attempts)
        super().__init__(
            f"{where}: every engine in the fallback chain failed — {detail}")


class PatternMismatchError(ResilienceError):
    """A value-only refactorization received a different sparsity pattern.

    where:  the component that detected the mismatch.
    detail: what differed — "shape", "indptr", "indices", "nnz", or
            "transformed-pattern drift".
    """

    def __init__(self, message: str, *, where: str = "", detail: str = ""):
        self.where = where
        self.detail = detail
        tail = f" [{detail}]" if detail else ""
        super().__init__(f"{where + ': ' if where else ''}{message}{tail}")


class AdmissionError(ResilienceError):
    """The serving tier rejected a request before it entered a queue.

    Raised eagerly by `repro_torch.serving.SolveService.submit` — a
    rejected request never consumes queue capacity, never holds a future,
    and the caller can retry/shed load immediately.

    tenant: the tenant whose request was rejected.
    depth:  the tenant's in-flight depth at rejection time.
    limit:  the configured cap (None when the rejection is not depth-based,
            e.g. submitting to a closed service).
    """

    def __init__(self, message: str, *, tenant: str = "default",
                 depth: int = 0, limit: int | None = None):
        self.tenant = tenant
        self.depth = depth
        self.limit = limit
        tail = f" (tenant {tenant!r}: depth {depth}" + \
            (f" >= cap {limit})" if limit is not None else ")")
        super().__init__(f"{message}{tail}")


class ScheduleInvariantError(ResilienceError):
    """A compiled schedule failed static verification.

    Raised by `repro_torch.analysis.verify.verify_level_schedule` (and
    through it by `validate_schedule` and strict-mode operator builds) when
    a `LevelSchedule` violates a structural invariant: a lane reads a row
    or carry segment that is not finalized at a strictly earlier step, a
    row is finalized more or fewer than exactly once, an ELL index or carry
    slot is out of bounds, or the packed nnz disagrees with the matrix.
    `verify_packed_schedule` / `verify_packed_values` raise it for the
    SpTRSV kernel's packed form of a schedule.  The schedule must never
    execute — a violating schedule can return a *finite but wrong* answer.

    check: the invariant that failed (e.g. "race", "bijection",
           "index-bounds", "carry-order", "nnz", "dtype", "collectives").
    step:  the first offending step index (-1 when not step-local).
    lane:  the first offending lane index within that step (-1 when not
           lane-local).
    group: the width-group index the lane belongs to (-1 when global).
    """

    def __init__(self, message: str, *, check: str, step: int = -1,
                 lane: int = -1, group: int = -1, where: str = ""):
        self.check = check
        self.step = int(step)
        self.lane = int(lane)
        self.group = int(group)
        self.where = where
        loc = ""
        if step >= 0:
            loc = f" at step {step}"
            if lane >= 0:
                loc += f", lane {lane}"
            if group >= 0:
                loc += f" (group {group})"
        head = f"{where}: " if where else ""
        super().__init__(f"{head}[{check}] {message}{loc}")


class TransformInvariantError(ResilienceError):
    """A TransformedSystem or its ReplayPlan failed the transform audit.

    Raised by `repro_torch.analysis.verify.audit_transformed_system`: the
    rewritten dependency matrix is not strictly lower triangular, a level
    assignment is non-monotone along an edge, the fill accounting disagrees
    with `TransformMetrics`, or a replay-plan commit indexes out of bounds.
    Replaying or scheduling such a system would produce a finite wrong
    answer, so the audit is an eager, typed error.

    check: the invariant that failed (e.g. "triangularity",
           "level-monotonicity", "fill-accounting", "replay-bounds").
    """

    def __init__(self, message: str, *, check: str, where: str = ""):
        self.check = check
        self.where = where
        head = f"{where}: " if where else ""
        super().__init__(f"{head}[{check}] {message}")


class ResilienceWarning(UserWarning):
    """Base class for resilience-layer warnings (downgrades are loud)."""


class EngineFallbackWarning(ResilienceWarning):
    """A solve was downgraded to a fallback engine."""


class HealthRepairWarning(ResilienceWarning):
    """A health violation was repaired or recovered via fallback."""


class CacheQuarantineWarning(ResilienceWarning):
    """A corrupt/stale disk-cache entry was quarantined to `.bad/`."""


class TunerFailureWarning(ResilienceWarning):
    """A background tuning job failed; the untuned operator keeps serving.

    Emitted by `repro_torch.serving.OperatorRegistry` when a
    `StrategyPortfolio` run raises off the request path: the entry is
    marked "degraded" (visible in `ServiceStats`/`registry.stats()`),
    requests continue through the admitted `no_rewriting` operator, and
    nothing blocks."""


# -- health policy ------------------------------------------------------------

_NONFINITE_ACTIONS = ("raise", "fallback", "repair")
HEALTH_ENV_VAR = "REPRO_HEALTH_CHECKS"


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """What SolveGuard checks and how violations are handled.

    check_inputs:   reject non-finite right-hand sides (always an error:
                    garbage in cannot be repaired).
    check_outputs:  detect non-finite solutions.
    on_nonfinite:   action for an unhealthy OUTPUT, and for an engine
                    chain that is exhausted — "raise" a typed error;
                    "fallback" to the float64 host reference solve;
                    "repair" by sanitizing + iterative refinement through
                    the operator's own engine, escalating to the host
                    reference if refinement cannot reach `residual_tol`.
                    The host reference serves CPU-staged operators only:
                    on a card what the kernel cannot serve or repair
                    raises.
    residual_check: additionally verify the relative residual
                    max|b - Ax| / max(1, max|b|) against the ORIGINAL
                    matrix on every solve (costs one host matvec).
    residual_tol:   threshold for the residual check and the repair
                    target.  Looser than the refinement tolerance: it
                    flags wrong answers, not last-ulp noise.
    max_repair_rounds: refinement rounds "repair" may spend before
                    escalating to the host reference.
    verify_schedule: statically verify compiled schedules and transform
                    plans (`repro_torch.analysis.verify`) before they serve
                    a solve: operator builds certify the schedule and the
                    SpTRSV kernel's packed forms of it once, before the
                    first pack is made for a launch and before the disk
                    store (cached artifacts keep their certificates, so
                    cache hits re-verify nothing); value updates re-audit
                    the numeric payload and the refreshed packed words.
                    Violations raise ScheduleInvariantError /
                    TransformInvariantError.
    """

    check_inputs: bool = True
    check_outputs: bool = True
    on_nonfinite: str = "raise"
    residual_check: bool = False
    residual_tol: float = 1e-5
    max_repair_rounds: int = 3
    verify_schedule: bool = False

    def __post_init__(self):
        if self.on_nonfinite not in _NONFINITE_ACTIONS:
            raise ValueError(
                f"on_nonfinite must be one of {_NONFINITE_ACTIONS}, got "
                f"{self.on_nonfinite!r}")

    @property
    def enabled(self) -> bool:
        return self.check_inputs or self.check_outputs or self.residual_check

    @classmethod
    def off(cls) -> "HealthPolicy":
        return cls(check_inputs=False, check_outputs=False,
                   residual_check=False)

    @classmethod
    def strict(cls) -> "HealthPolicy":
        """Finiteness + residual + static schedule verification,
        violations raise."""
        return cls(residual_check=True, verify_schedule=True)


_NAMED_POLICIES = {
    "off": HealthPolicy.off,
    "0": HealthPolicy.off,
    "on": HealthPolicy,
    "1": HealthPolicy,
    "strict": HealthPolicy.strict,
    "repair": lambda: HealthPolicy(on_nonfinite="repair"),
    "fallback": lambda: HealthPolicy(on_nonfinite="fallback"),
}


def resolve_health_policy(spec=None) -> HealthPolicy:
    """Resolve a health spec: a HealthPolicy passes through, a named level
    constructs one, None reads REPRO_HEALTH_CHECKS (default "on")."""
    if isinstance(spec, HealthPolicy):
        return spec
    if spec is None:
        spec = os.environ.get(HEALTH_ENV_VAR, "on").strip().lower() or "on"
    if isinstance(spec, str):
        try:
            return _NAMED_POLICIES[spec.strip().lower()]()
        except KeyError:
            raise ValueError(
                f"unknown health policy {spec!r}; expected one of "
                f"{sorted(_NAMED_POLICIES)} or a HealthPolicy") from None
    raise TypeError(f"health spec must be None, a named level, or a "
                    f"HealthPolicy, got {type(spec).__name__}")


class SolveGuard:
    """Health validation for one solve, per a HealthPolicy.

    The guard only *detects* and *classifies* — recovery (host reference
    fallback, refinement repair) is the owning component's job, because it
    alone holds the original matrix and the device pipeline.  See
    `TriangularOperator.solve` for the canonical consumer.
    """

    def __init__(self, policy: HealthPolicy, where: str = "solve"):
        self.policy = policy
        self.where = where

    def require_finite_input(self, b) -> None:
        """Non-finite right-hand sides are always an error."""
        if not self.policy.check_inputs:
            return
        if not np.isfinite(np.asarray(b)).all():
            raise NumericalHealthError(
                f"right-hand side contains NaN/Inf entries in {self.where}",
                stage="input", where=self.where)

    def output_unhealthy(self, x) -> str | None:
        """Classify an output: None (healthy) or a reason string."""
        if self.policy.check_outputs and \
                not np.isfinite(np.asarray(x)).all():
            return "solution contains NaN/Inf entries"
        return None

    def residual_unhealthy(self, resid: float) -> str | None:
        """Classify a relative residual (NaN counts as unhealthy)."""
        if not self.policy.residual_check:
            return None
        if not (resid <= self.policy.residual_tol):
            return (f"relative residual {resid:.3e} exceeds "
                    f"{self.policy.residual_tol:.1e}")
        return None


# -- declarative retry --------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Geometric-backoff retry shared by the flaky host-side paths.

    One attempt runs with parameter 0.0; each retry grows the parameter
    geometrically from `scale0` (Manteuffel diagonal shifts in
    `precond.factorize`, where the parameter is the shift alpha — but the
    policy is payload-agnostic: any `attempt(param)` callable works).

    max_attempts: retries after the first attempt (0 = no retry; the
                  first failure propagates).
    scale0:       parameter of the first retry.
    growth:       multiplier per further retry.
    """

    max_attempts: int = 20
    scale0: float = 1e-3
    growth: float = 2.0

    def params(self):
        """0.0, scale0, scale0*growth, ... — max_attempts + 1 values."""
        yield 0.0
        p = self.scale0
        for _ in range(self.max_attempts):
            yield p
            p *= self.growth

    def run(self, attempt, *, retry_on: tuple = (Exception,)):
        """Run `attempt(param)` over the parameter ladder.

        Returns (result, param, attempts) on the first success; re-raises
        the last `retry_on` exception when the ladder is exhausted.  Other
        exception types propagate immediately.
        """
        attempts = 0
        last = None
        for param in self.params():
            attempts += 1
            try:
                return attempt(param), param, attempts
            except retry_on as e:
                last = e
        raise last
