"""Preconditioner facade: factor A, build the operator pair, serve M^-1.

Port of `repro.precond.api` for a fixed strategy:

    P = Preconditioner.ic0(A, tune="no_rewriting")   # SPD:     M = L L^T
    P = Preconditioner.ilu0(A, tune="avgLevelCost")  # general: M = L U
    z = P(r)                                         # z = M^-1 r

1. `precond.factorize` produces the numeric zero-fill factor(s), with
   breakdown detection and diagonal shifting (`P.factors.shift`).
2. Two cached `TriangularOperator`s are built with the named strategy:
   forward `L`, backward `L^T` (ic0, transpose=True) or `U` (ilu0,
   side="upper"), on the card unless the caller passes `device="cpu"`.

`P(r)` dispatches on the input: a torch tensor goes through
`device_apply` (both sweeps on the operators' device, tensor out), a
numpy array through the host `apply` (float64 numpy out).

Not ported yet, each raising NotImplementedError (ROADMAP.md, queue 1):
`tune="auto"` (the joint pair tuner, item 1), `refactor` (needs
`update_values`, item 3) and `mesh=` (sharded sweeps, item 8).
"""
from __future__ import annotations

import numpy as np
import torch

from ..solver.operator import TriangularOperator
from ..sparse.csr import CSR
from . import factorize
from .factorize import FactorResult

__all__ = ["Preconditioner", "IdentityPreconditioner"]


def _require_strategy(tune) -> None:
    if tune == "auto":
        raise NotImplementedError(
            "tune='auto' needs the joint pair tuner (StrategyPortfolio."
            "tune_pair), which the port does not have yet (ROADMAP.md, "
            "queue 1, item 1: tuner); pass a strategy name such as "
            "'no_rewriting' or 'avgLevelCost'")


class Preconditioner:
    """Paired triangular operators applying M^-1 = (L L^T)^-1 or (L U)^-1.

    Construct via the classmethods (`ic0`, `ilu0`, or `from_factors` for a
    factor computed elsewhere); the constructor itself just binds the
    pieces.  Attributes:

    factors:  the FactorResult (factor CSRs, shift, attempts).
    forward:  TriangularOperator for the L sweep.
    backward: TriangularOperator for the L^T / U sweep.
    strategy: the strategy label both operators were compiled with.
    device:   the operators' device.
    """

    def __init__(self, factors: FactorResult, forward: TriangularOperator,
                 backward: TriangularOperator):
        if forward.device != backward.device:
            raise ValueError(f"the two sweeps lie on different devices: "
                             f"{forward.device} and {backward.device}")
        self.factors = factors
        self.forward = forward
        self.backward = backward
        self.strategy = forward.strategy
        self.device = forward.device
        self._device_fns: dict = {}

    # -- construction ---------------------------------------------------------
    @classmethod
    def ic0(cls, A: CSR, tune="auto", **kwargs) -> "Preconditioner":
        """Incomplete-Cholesky preconditioner M = L L^T for SPD A.

        Factorization knobs (shift0, max_shift_attempts, breakdown_rtol,
        check_symmetric) ride in `factor_kwargs`; everything else is
        forwarded to `from_factors`.
        """
        _require_strategy(tune)
        factor_kwargs = kwargs.pop("factor_kwargs", None) or {}
        fac = factorize.ic0(A, **factor_kwargs)
        return cls.from_factors(fac, tune=tune, **kwargs)

    @classmethod
    def ilu0(cls, A: CSR, tune="auto", **kwargs) -> "Preconditioner":
        """Incomplete-LU preconditioner M = L U for general square A."""
        _require_strategy(tune)
        factor_kwargs = kwargs.pop("factor_kwargs", None) or {}
        fac = factorize.ilu0(A, **factor_kwargs)
        return cls.from_factors(fac, tune=tune, **kwargs)

    @classmethod
    def from_factors(cls, fac: FactorResult, tune="auto", *,
                     chunk: int = 256, max_deps: int = 16, dtype=np.float32,
                     engine=None, device=None, mesh=None,
                     cache: bool = True) -> "Preconditioner":
        """Build the operator pair for an existing FactorResult.

        tune:   a stable strategy name or Strategy instance; both operators
                use it.  "auto" (the joint pair tuner, the reference's
                default) raises NotImplementedError.
        device: "cuda" (the default when None) or "cpu"; None without CUDA
                raises RuntimeError.
        mesh:   raises NotImplementedError (module doc).
        Remaining arguments match TriangularOperator.from_csr.
        """
        _require_strategy(tune)
        if mesh is not None:
            raise NotImplementedError(
                "mesh= needs the port's sharded solves (ROADMAP.md, queue "
                "1, item 8: sharded solves)")
        op_kw = dict(chunk=chunk, max_deps=max_deps, dtype=dtype,
                     engine=engine, device=device, cache=cache)
        forward = TriangularOperator.from_csr(fac.L, tune, side="lower",
                                              transpose=False, **op_kw)
        if fac.kind == "ic0":
            backward = TriangularOperator.from_csr(fac.L, tune, side="lower",
                                                   transpose=True, **op_kw)
        else:
            backward = TriangularOperator.from_csr(fac.U, tune, side="upper",
                                                   transpose=False, **op_kw)
        return cls(fac, forward, backward)

    def refactor(self, new_A: CSR, **factor_kwargs) -> "Preconditioner":
        """Numeric-only re-preconditioning for a new A on the same pattern:
        not ported yet.  It re-binds both operators through
        `TriangularOperator.update_values`, which the port does not have
        (ROADMAP.md, queue 1, item 3); build a new Preconditioner instead.
        """
        raise NotImplementedError(
            "Preconditioner.refactor needs TriangularOperator.update_values, "
            "which the port does not have yet (ROADMAP.md, queue 1, item 3: "
            "update_values); build a new Preconditioner.ic0/ilu0(A) instead")

    # -- application ----------------------------------------------------------
    @property
    def n(self) -> int:
        return self.factors.n

    def apply(self, r: np.ndarray, *, engine=None, max_refine: int = 0,
              refine_tol: float = 1e-10, health=None) -> np.ndarray:
        """z = M^-1 r on the host: forward sweep then backward sweep, each
        a `TriangularOperator.solve` (numpy in, device sweep, numpy out).

        Refinement defaults off (max_refine=0): M^-1 is approximate by
        construction, and a fixed slightly perturbed M only changes the
        Krylov convergence rate, not the attainable outer residual.  The
        sweeps run in the schedule dtype; only the returned z is cast up
        to float64.  `health` goes to both sweeps' SolveGuard.
        """
        z = self.forward.solve(r, engine=engine, max_refine=max_refine,
                               refine_tol=refine_tol, health=health)
        z = self.backward.solve(z, engine=engine, max_refine=max_refine,
                                refine_tol=refine_tol, health=health)
        return np.asarray(z, dtype=np.float64)

    def device_apply(self, engine=None):
        """The full M^-1 application as a tensor -> tensor callable on the
        operators' device: the forward and backward `device_solve_fn`s
        (reversal + T-factor preamble + schedule, each in the schedule
        dtype, cast back to the input's dtype) composed back to back.  No
        host round trip.  A tensor on another device raises."""
        key = None if engine is None else str(engine)
        fn = self._device_fns.get(key)
        if fn is None:
            f = self.forward.device_solve_fn(engine)
            g = self.backward.device_solve_fn(engine)
            device = self.device

            def fn(r: torch.Tensor) -> torch.Tensor:
                if r.device.type != device.type:
                    raise ValueError(f"the preconditioner lies on {device}, "
                                     f"the vector on {r.device}")
                return g(f(r))

            self._device_fns[key] = fn
        return fn

    def __call__(self, r):
        """Dispatch on the input: torch tensors go through device_apply,
        anything else through the host `apply`."""
        if isinstance(r, torch.Tensor):
            return self.device_apply()(r)
        return self.apply(np.asarray(r))

    def stats(self) -> dict:
        """Merged factorization + per-operator solve stats.

        The forward/backward counters tick on host `apply()`/solve calls
        only; `device_apply` (the Krylov hot path) runs the sweeps without
        them.
        """
        return {
            "kind": self.factors.kind,
            "n": self.n,
            "nnz_L": self.factors.L.nnz,
            "nnz_U": (self.factors.U.nnz if self.factors.U is not None
                      else None),
            "shift": self.factors.shift,
            "factor_attempts": self.factors.attempts,
            "strategy": self.strategy,
            "forward": self.forward.stats.to_dict(),
            "backward": self.backward.stats.to_dict(),
        }

    def __repr__(self) -> str:  # pragma: no cover
        return (f"Preconditioner(kind={self.factors.kind!r}, n={self.n}, "
                f"strategy={self.strategy!r}, shift={self.factors.shift}, "
                f"device={self.device})")


class IdentityPreconditioner:
    """M = I — the no-preconditioning baseline with the same interface
    (for like-for-like iteration counts in benchmarks and tests)."""

    def apply(self, r):
        return np.asarray(r)

    def __call__(self, r):
        return r

    def stats(self) -> dict:
        return {"kind": "identity"}
