"""Preconditioner facade: factor A, tune the pair, serve M^-1.

Port of `repro.precond.api`:

    P = Preconditioner.ic0(A)                        # SPD:     M = L L^T
    P = Preconditioner.ilu0(A, device="cpu")         # general: M = L U
    z = P(r)                                         # z = M^-1 r

1. `precond.factorize` produces the numeric zero-fill factor(s), with
   breakdown detection and diagonal shifting (`P.factors.shift`).
2. With `tune="auto"` (the default) the strategy portfolio tunes the PAIR
   jointly (`StrategyPortfolio.tune_pair`): one strategy minimizing the
   summed cost of both sweeps, memoized under the system matrix's
   fingerprint and the tuning configuration; with `measure_top_k > 0`
   the model's top-k and the no_rewriting baseline are re-timed as the
   composed M^-1 that a Krylov loop runs.
3. Two cached `TriangularOperator`s are built with the strategy: forward
   `L`, backward `L^T` (ic0, transpose=True) or `U` (ilu0,
   side="upper"), on the card unless the caller passes `device="cpu"`.

`P(r)` dispatches on the input: a torch tensor goes through
`device_apply` (both sweeps on the operators' device, tensor out), a
numpy array through the host `apply` (float64 numpy out).

`P.refactor(A_new)` re-factors a matrix on the same pattern and re-binds
both operators through `TriangularOperator.update_values` (on the card,
a device refresh of the SpTRSV kernel's packed tiles); the pair decision
and everything structural are kept.

`mesh=` (a torch.distributed DeviceMesh, with `mesh_axis=`) serves BOTH
sweeps through the sharded engine over that axis, so M^-1 (host `apply`
or `device_apply`) runs under one mesh with no host round trip between
the sweeps; pair decisions then use the sharded cost model, and the
measured pair mode's timings are the axis' first rank's on every rank.
"""
from __future__ import annotations

import collections
import dataclasses as _dc
import hashlib
import threading
import time

import numpy as np
import torch

from ..solver.operator import (TriangularOperator, candidate_sweep_fn,
                               matrix_fingerprint, orient_lower)
from ..sparse.csr import CSR
from . import factorize
from .factorize import FactorResult

__all__ = ["Preconditioner", "IdentityPreconditioner"]


class Preconditioner:
    """Paired triangular operators applying M^-1 = (L L^T)^-1 or (L U)^-1.

    Construct via the classmethods (`ic0`, `ilu0`, or `from_factors` for a
    factor computed elsewhere); the constructor itself just binds the
    pieces.  Attributes:

    factors:  the FactorResult (factor CSRs, shift, attempts).
    forward:  TriangularOperator for the L sweep.
    backward: TriangularOperator for the L^T / U sweep.
    report:   slim PairReport when tune="auto" ran, else None.
    strategy: the strategy label both operators were compiled with.
    device:   the operators' device.
    """

    # (system fingerprint, kind, config) -> (Strategy, slim PairReport):
    # re-preconditioning the same A re-uses the pair decision without
    # re-running the portfolio.  Bounded LRU; the tuning itself runs
    # outside the lock
    _pair_decisions: collections.OrderedDict = collections.OrderedDict()
    _pair_decisions_max: int = 16
    _pair_lock = threading.RLock()

    def __init__(self, factors: FactorResult, forward: TriangularOperator,
                 backward: TriangularOperator, report=None):
        if forward.device != backward.device:
            raise ValueError(f"the two sweeps lie on different devices: "
                             f"{forward.device} and {backward.device}")
        self.factors = factors
        self.forward = forward
        self.backward = backward
        self.report = report
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
        factor_kwargs = kwargs.pop("factor_kwargs", None) or {}
        fac = factorize.ic0(A, **factor_kwargs)
        return cls.from_factors(fac, tune=tune, system=A, **kwargs)

    @classmethod
    def ilu0(cls, A: CSR, tune="auto", **kwargs) -> "Preconditioner":
        """Incomplete-LU preconditioner M = L U for general square A."""
        factor_kwargs = kwargs.pop("factor_kwargs", None) or {}
        fac = factorize.ilu0(A, **factor_kwargs)
        return cls.from_factors(fac, tune=tune, system=A, **kwargs)

    @classmethod
    def from_factors(cls, fac: FactorResult, tune="auto", *, system=None,
                     chunk: int = 256, max_deps: int = 16, dtype=np.float32,
                     engine=None, device=None, mesh=None,
                     mesh_axis: str = "model",
                     cache: bool = True, cache_dir=None, cost_model=None,
                     measure_top_k: int = 0) -> "Preconditioner":
        """Build the operator pair for an existing FactorResult.

        tune:   "auto" — joint pair tuning through the strategy portfolio
                (memoized per system and configuration when `system` is
                given); a stable strategy name or Strategy instance — both
                operators use it directly.
        system: the original matrix A (the pair-decision memo's key;
                without it "auto" still tunes, and never memoizes).
        device: "cuda" (the default when None) or "cpu"; None without CUDA
                raises RuntimeError.
        cost_model/measure_top_k: as for `TriangularOperator.from_csr`;
                the measured pair mode times the composed M^-1 (module
                doc).
        mesh/mesh_axis: a DeviceMesh serves both sweeps through the
                sharded engine over `mesh_axis` (module doc), on the mesh's
                device.  Mutually exclusive with engine=.
        Remaining arguments match TriangularOperator.from_csr.
        """
        if mesh is not None:
            from ..solver.engines import resolve_engine
            engine = resolve_engine(engine, mesh=mesh, mesh_axis=mesh_axis)
        report = None
        if isinstance(tune, str) and tune == "auto":
            tune, report = cls._pair_decision(
                fac, system, chunk=chunk, max_deps=max_deps, dtype=dtype,
                engine=engine, device=device, cost_model=cost_model,
                measure_top_k=measure_top_k)
        op_kw = dict(chunk=chunk, max_deps=max_deps, dtype=dtype,
                     engine=engine, device=device, cache=cache,
                     cache_dir=cache_dir)
        forward = TriangularOperator.from_csr(fac.L, tune, side="lower",
                                              transpose=False, **op_kw)
        if fac.kind == "ic0":
            backward = TriangularOperator.from_csr(fac.L, tune, side="lower",
                                                   transpose=True, **op_kw)
        else:
            backward = TriangularOperator.from_csr(fac.U, tune, side="upper",
                                                   transpose=False, **op_kw)
        return cls(fac, forward, backward, report=report)

    @classmethod
    def _pair_decision(cls, fac: FactorResult, system, *, chunk, max_deps,
                       dtype, engine, device, cost_model, measure_top_k):
        """Joint pair tuning, memoized under the system fingerprint.

        Model ranking comes from `StrategyPortfolio.tune_pair`; when
        `measure_top_k > 0` the model's top-k candidates PLUS the
        `no_rewriting` baseline are re-timed as the composed M^-1 a Krylov
        loop runs (`_measure_pair`), so the pick is never slower than
        no_rewriting up to timer noise.  The decision depends on the
        engine (what a step costs it) and the cost model, both in the key.
        """
        from ..core.portfolio import (StrategyPortfolio,
                                      default_cost_model_for)
        from ..solver.engines import resolve_placement
        eng, dev = resolve_placement(engine, device)
        if cost_model is None:
            cost_model = default_cost_model_for(eng)
        key = None
        if system is not None:
            cfg = (fac.kind, chunk, max_deps, np.dtype(dtype).name,
                   measure_top_k, eng.cache_token(), str(dev),
                   tuple(sorted(_dc.asdict(cost_model).items())))
            key = matrix_fingerprint(system) + "-" + hashlib.sha256(
                repr(cfg).encode()).hexdigest()[:16]
            with cls._pair_lock:
                hit = cls._pair_decisions.get(key)
                if hit is not None:
                    cls._pair_decisions.move_to_end(key)
                    return hit
        fwd_sys, _ = orient_lower(fac.L, "lower", False)
        if fac.kind == "ic0":
            bwd_sys, bwd_rev = orient_lower(fac.L, "lower", True)
        else:
            bwd_sys, bwd_rev = orient_lower(fac.U, "upper", False)
        tuner = StrategyPortfolio(chunk=chunk, max_deps=max_deps,
                                  dtype=dtype, cost_model=cost_model,
                                  measure_top_k=0, engine=eng, device=dev)
        pair = tuner.tune_pair(fwd_sys, bwd_sys)
        best_label = pair.best_label
        if measure_top_k > 0:
            best_label = cls._measure_pair(pair, bwd_rev, engine=eng,
                                           device=dev, dtype=dtype,
                                           top_k=measure_top_k)
        best = next(c for c in pair.fwd.candidates if c.label == best_label)
        decision = (best.strategy, pair.slim())
        if key is not None:
            with cls._pair_lock:
                cls._pair_decisions[key] = decision
                cls._pair_decisions.move_to_end(key)
                while len(cls._pair_decisions) > cls._pair_decisions_max:
                    cls._pair_decisions.popitem(last=False)
        return decision

    @staticmethod
    def _measure_pair(pair, bwd_reversed: bool, *, engine, device, dtype,
                      top_k: int, reps: int = 3) -> str:
        """Re-rank candidate labels by the measured wall time of one
        composed M^-1 application (both sweeps as `device_solve_fn` serves
        them, back to back; wall time around work that ends in a
        synchronize, minimum over reps, warm-up outside the timer);
        updates pair.combined in place and returns the winner.  The
        no_rewriting baseline is always measured."""
        from ..solver.levelset import torch_dtype
        labels = [c["label"] for c in pair.combined[:top_k]]
        if "no_rewriting" not in labels and any(
                c["label"] == "no_rewriting" for c in pair.combined):
            labels.append("no_rewriting")
        by_label_f = {c.label: c for c in pair.fwd.candidates
                      if c.error is None}
        by_label_b = {c.label: c for c in pair.bwd.candidates
                      if c.error is None}
        n = pair.fwd.matrix["n"]
        r = torch.as_tensor(np.random.default_rng(0).standard_normal(n),
                            dtype=torch_dtype(dtype), device=device)

        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        measured = {}
        for label in labels:
            cf, cb = by_label_f[label], by_label_b[label]
            f = candidate_sweep_fn(cf.ts, cf.sched, engine, device)
            g = candidate_sweep_fn(cb.ts, cb.sched, engine, device,
                                   bwd_reversed)
            g(f(r))                             # warm-up outside the timer
            sync()
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                g(f(r))
                sync()
                best = min(best, time.perf_counter() - t0)
            measured[label] = best * 1e6
        # every rank of a mesh takes its first rank's timings, so that all
        # of them build the same pair
        measured = engine.agree(measured)
        for c in pair.combined:
            if c["label"] in measured:
                # total_us becomes the measured composed-apply time;
                # fwd_us/bwd_us stay as the per-side MODEL estimates
                c.update(measured=True,
                         total_us=round(measured[c["label"]], 1))
        pair.combined.sort(key=lambda c: (not c["measured"], c["total_us"]))
        winner = min(measured, key=measured.get)
        pair.best_label = winner
        return winner

    @classmethod
    def clear_pair_decisions(cls) -> None:
        with cls._pair_lock:
            cls._pair_decisions.clear()

    def refactor(self, new_A: CSR, **factor_kwargs) -> "Preconditioner":
        """Numeric-only re-preconditioning for a new A on the SAME pattern.

        The refactorization fast path for time-stepping / Newton outer
        loops: re-runs only the ic0/ilu0 value sweep over the frozen
        pattern plan (`factorize.refactor`), then re-binds both triangular
        operators in place through `TriangularOperator.update_values` —
        pair tuning, level analysis, transformations and schedule layouts
        are all reused.  Mutates this preconditioner and returns self.

        A pattern-changing A raises PatternMismatchError (build a fresh
        Preconditioner instead); `factor_kwargs` forwards shift0 /
        max_shift_attempts / breakdown_rtol to `factorize.refactor`.
        """
        fac = factorize.refactor(self.factors, new_A, **factor_kwargs)
        self.forward.update_values(fac.L)
        self.backward.update_values(fac.L if fac.kind == "ic0" else fac.U)
        self.factors = fac
        # composed device pipelines close over the old payloads' staged
        # schedules — drop them so the next device_apply recomposes
        self._device_fns.clear()
        return self

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
        to float64.  `health` goes to both sweeps' SolveGuard: a
        HealthPolicy, a named level ("off" | "on" | "strict" | "repair" |
        "fallback"), or None for the REPRO_HEALTH_CHECKS default
        (TriangularOperator.solve).
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
