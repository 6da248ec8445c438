"""Solve-path health checks: the typed error taxonomy, `HealthPolicy` and
the `SolveGuard` that enforces it.

Copy of the parts of `repro.core.resilience` that the port's operator
uses.  The port's solve never repairs and never walks a fallback chain:
an unhealthy solve raises (the repair/fallback actions, engine fallback
chains, the cache quarantine and `RetryPolicy` are still to be ported,
see ROADMAP.md).

Error taxonomy
==============
    ResilienceError(RuntimeError)
    ├── NumericalHealthError     non-finite / inaccurate solve data; carries
    │                            `.stage` ("input"|"output"|"residual")
    │                            and `.where`
    └── PatternMismatchError     a value-only refactorization was handed a
                                 matrix whose sparsity pattern differs from
                                 the frozen one; carries `.where` and
                                 `.detail`

Health policy
=============
`HealthPolicy` is resolved per solve: an explicit `HealthPolicy` instance,
a named level (`"off" | "on" | "strict"`), or `None` for the
`REPRO_HEALTH_CHECKS` environment default (same names; unset means
`"on"`).  `"on"` checks input/output finiteness and raises typed errors;
`"strict"` additionally checks the relative residual against the original
matrix.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

__all__ = ["ResilienceError", "NumericalHealthError", "PatternMismatchError",
           "HealthPolicy", "SolveGuard", "resolve_health_policy"]


# -- error taxonomy -----------------------------------------------------------


class ResilienceError(RuntimeError):
    """Base class for typed solve-path failures (module doc taxonomy)."""


class NumericalHealthError(ResilienceError):
    """A solve's data failed a health check.

    stage: "input" (non-finite right-hand side), "output" (non-finite
           solution), or "residual" (finite but inaccurate solution).
    where: the component that detected it (operator repr, facade name).
    """

    def __init__(self, message: str, *, stage: str, where: str = ""):
        self.stage = stage
        self.where = where
        super().__init__(f"[{stage}] {message}")


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


# -- health policy ------------------------------------------------------------

HEALTH_ENV_VAR = "REPRO_HEALTH_CHECKS"


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """What SolveGuard checks.  Every violation raises.

    check_inputs:   reject non-finite right-hand sides.
    check_outputs:  reject non-finite solutions.
    residual_check: additionally verify the relative residual
                    max|b - Ax| / max(1, max|b|) against the ORIGINAL
                    matrix on every solve (costs one host matvec).
    residual_tol:   threshold for the residual check.  Looser than the
                    refinement tolerance: it flags wrong answers, not
                    last-ulp noise.
    """

    check_inputs: bool = True
    check_outputs: bool = True
    residual_check: bool = False
    residual_tol: float = 1e-5

    @classmethod
    def off(cls) -> "HealthPolicy":
        return cls(check_inputs=False, check_outputs=False,
                   residual_check=False)

    @classmethod
    def strict(cls) -> "HealthPolicy":
        """Finiteness + residual, violations raise."""
        return cls(residual_check=True)


_NAMED_POLICIES = {
    "off": HealthPolicy.off,
    "0": HealthPolicy.off,
    "on": HealthPolicy,
    "1": HealthPolicy,
    "strict": HealthPolicy.strict,
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

    The guard detects and classifies; the owning component raises.  See
    `TriangularOperator.solve` for the consumer.
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
