"""TriangularOperator: cached end-to-end SpTRSV facade on torch devices.

Port of `repro.solver.operator` for a fixed strategy:

    op = TriangularOperator.from_csr(L, tune="avgLevelCost")   # on "cuda"
    x  = op.solve(b)                                # b: (n,) or (n, k)
    f  = op.device_solve_fn()                       # tensor -> tensor

`from_csr` orients the sweep to a lower-triangular system, runs the graph
transformation for the named strategy, compiles the width-bucketed
LevelSchedule (the numpy host half, copied from `repro`), and keeps the
artifact in an in-memory cache keyed by the matrix fingerprint and the
configuration.  The schedule is staged once per device; the engine is the
CUDA kernel on a card and the plain PyTorch body on the CPU.  The device
is `cuda` unless the caller passes `device="cpu"`; without CUDA and
without `device=`, construction raises.

All four triangular sweeps share one lower-triangular pipeline:
`side="lower"|"upper"` selects the stored triangle, `transpose=True`
solves with its transpose; `op.transposed()` is the adjoint operator.

`solve` runs the T-factor preamble on the host, the compiled schedule on
the device in the schedule dtype (float32 by default), then iteratively
refines in float64 on the host against the ORIGINAL matrix.  It runs
under a `SolveGuard`: a non-finite right-hand side, a non-finite solution
or (under `health="strict"`) a large residual raises
`NumericalHealthError`.  Nothing is repaired, and no engine stands in for
a failing one.

Not ported yet (ROADMAP.md, queue 1): `tune="auto"`, the disk cache,
`update_values`, `mesh=`, engine fallback chains, health repair and the
host-reference escape hatch, and tracing spans.
"""
from __future__ import annotations

import collections
import hashlib
import threading
import time

import numpy as np
import torch

from ..sparse.csr import CSR, reverse_both

__all__ = ["TriangularOperator", "OperatorStats", "matrix_fingerprint",
           "value_fingerprint", "orient_lower", "compose_sweep_fn"]

CACHE_VERSION = 3


def orient_lower(A: CSR, side: str, transpose: bool) -> tuple:
    """Reduce any triangular solve to a lower-triangular one.

    Returns (L_eff, reversed): solve(A, b, side, transpose) ==
    unreverse(solve_lower(L_eff, reverse(b))), where reverse flips axis 0
    iff `reversed`.  The four sweeps:

      (lower, False)  L x  = b   ->  L itself
      (upper, True)   U'x  = b   ->  U' (already lower)
      (lower, True)   L'x  = b   ->  P L' P, rows/cols reversed
      (upper, False)  U x  = b   ->  P U  P, rows/cols reversed
    """
    if side not in ("lower", "upper"):
        raise ValueError(f"side must be 'lower' or 'upper', got {side!r}")
    lower = side == "lower"
    if lower and not transpose:
        return A, False
    if not lower and transpose:
        return A.transpose(), False
    if lower:                       # lower, transpose
        return reverse_both(A.transpose()), True
    return reverse_both(A), True    # upper, no transpose


def compose_sweep_fn(main_fn, schedule_dtype: torch.dtype, pre_fn, src,
                     row_pos, reversed_: bool):
    """Compose one triangular sweep as a tensor -> tensor callable: axis
    reversal (transpose/upper orientations) -> T-factor preamble -> main
    schedule -> un-reverse, in the schedule dtype, cast back to the
    input's dtype.  `pre_fn`/`src`/`row_pos` are None for identity
    preambles; `src`/`row_pos` are index tensors on the schedule's device.
    """

    def fn(v: torch.Tensor) -> torch.Tensor:
        out_dtype = v.dtype
        c = v.to(schedule_dtype)
        if reversed_:
            c = torch.flip(c, (0,))
        if pre_fn is not None:
            c = pre_fn(c[src])[row_pos]
        x = main_fn(c)
        if reversed_:
            x = torch.flip(x, (0,))
        return x.to(out_dtype)

    return fn


def matrix_fingerprint(L: CSR, include_values: bool = True) -> str:
    """Stable hash of a CSR matrix: shape + pattern (+ values by default)."""
    h = hashlib.sha256()
    h.update(repr((CACHE_VERSION, L.shape)).encode())
    h.update(np.ascontiguousarray(L.indptr).tobytes())
    h.update(np.ascontiguousarray(L.indices).tobytes())
    if include_values:
        h.update(np.ascontiguousarray(L.data).tobytes())
    return h.hexdigest()[:32]


def value_fingerprint(L: CSR) -> str:
    """Stable hash of the numeric payload alone (16 hex chars)."""
    h = hashlib.sha256()
    h.update(repr((CACHE_VERSION, L.shape)).encode())
    h.update(np.ascontiguousarray(L.data).tobytes())
    return h.hexdigest()[:16]


class OperatorStats:
    """Per-operator solve statistics, updated by every solve().

    The field names and `to_dict()` match the reference's; the metrics-
    registry view behind them is still to be ported.  Updates take one
    lock per event, so concurrent solves never interleave a record.
    """

    _FIELDS = ("solves", "rhs_columns", "refine_rounds", "total_solve_ms",
               "last_solve_ms", "last_residual", "cache_source", "tune_ms",
               "value_updates", "last_update_ms", "fallbacks",
               "fallback_downgrades", "last_fallback", "health_events",
               "last_health_event")

    def __init__(self, cache_source: str = "built", tune_ms: float = 0.0):
        self._lock = threading.Lock()
        self.solves = 0
        self.rhs_columns = 0
        self.refine_rounds = 0
        self.total_solve_ms = 0.0
        self.last_solve_ms = 0.0
        self.last_residual = float("nan")
        self.cache_source = cache_source
        self.tune_ms = float(tune_ms)
        # the port neither updates values, falls back nor repairs yet:
        # these stay at their initial values
        self.value_updates = 0
        self.last_update_ms = 0.0
        self.fallbacks = 0
        self.fallback_downgrades = 0
        self.last_fallback = ""
        self.health_events = 0
        self.last_health_event = ""

    def to_dict(self) -> dict:
        with self._lock:
            return {name: getattr(self, name) for name in self._FIELDS}

    def record_solve(self, *, ms: float, columns: int, rounds: int,
                     residual: float) -> None:
        with self._lock:
            self.solves += 1
            self.rhs_columns += columns
            self.refine_rounds += rounds
            self.total_solve_ms += ms
            self.last_solve_ms = ms
            self.last_residual = residual

    def record_health_event(self, last: str) -> None:
        with self._lock:
            self.health_events += 1
            self.last_health_event = last

    def __repr__(self) -> str:    # pragma: no cover
        return "OperatorStats(" + ", ".join(
            f"{k}={v!r}" for k, v in self.to_dict().items()) + ")"


class TriangularOperator:
    """Compiled triangular-solve operator for one matrix (see module doc)."""

    # bounded LRU: payloads hold full transforms + ELL tiles (MB-scale per
    # large matrix), so a long-lived process over many matrices must not
    # accumulate them forever
    _memory_cache_max: int = 16
    _memory_cache = collections.OrderedDict()
    _cache_lock = threading.RLock()

    @classmethod
    def _memory_get(cls, key: str):
        with cls._cache_lock:
            payload = cls._memory_cache.get(key)
            if payload is not None:
                cls._memory_cache.move_to_end(key)
            return payload

    @classmethod
    def _memory_put(cls, key: str, payload: dict) -> None:
        with cls._cache_lock:
            cls._memory_cache[key] = payload
            cls._memory_cache.move_to_end(key)
            while len(cls._memory_cache) > cls._memory_cache_max:
                cls._memory_cache.popitem(last=False)

    @classmethod
    def clear_memory_cache(cls) -> None:
        with cls._cache_lock:
            cls._memory_cache.clear()

    def __init__(self, L: CSR, payload: dict, cache_source: str, *,
                 device: torch.device, engine):
        self._L = L                 # the ORIGINAL matrix, as handed in
        self._payload = payload
        self._ts = payload["ts"]    # transform of the oriented lower system
        self._sched = payload["sched"]
        self.strategy = payload["strategy"]
        cfg = payload["config"]
        self._config = cfg
        self.side = cfg["side"]
        self.transpose = bool(cfg["transpose"])
        self._reversed = bool(payload["reversed"])
        self.device = device
        self._engine = engine
        self._build_kwargs = {}     # filled by from_csr for transposed()
        # staged schedules + compiled fns live on the shared payload, one
        # entry per device, so memory-cache hits share them.  "compiled"
        # maps engine name -> (engine instance, fn); the instance is kept
        # for an identity check so two engines sharing a name never swap
        # compiled code.
        self._runtime = payload.setdefault("_runtime", {}).setdefault(
            str(device), {"compiled": {}, "pre_compiled": {}})
        self.stats = OperatorStats(cache_source=cache_source,
                                   tune_ms=payload.get("tune_ms", 0.0))

    @property
    def engine(self) -> str:
        """Name of the default engine."""
        return self._engine.name

    # -- construction ---------------------------------------------------------
    @classmethod
    def from_csr(cls, L: CSR, tune="auto", *, side: str = "lower",
                 transpose: bool = False, chunk: int = 256,
                 max_deps: int = 16, dtype=np.float32, engine=None,
                 device=None, cache: bool = True) -> "TriangularOperator":
        """Build (or fetch from the memory cache) the operator for L.

        side/transpose: which sweep this operator performs (module doc).
        tune:   a stable strategy name ("avgLevelCost", ...) or a Strategy
                instance.  "auto" (the portfolio tuner, the reference's
                default) is not ported yet and raises NotImplementedError.
        engine: a registered name ("cuda", "torch"), an Engine, or None for
                the device's default ("cuda" on a card, "torch" on the CPU).
        device: "cuda" (the default when None) or "cpu"; None without CUDA
                raises RuntimeError.
        cache:  look up / keep the compiled artifact in memory, keyed by
                the matrix fingerprint and the configuration.
        """
        from ..core.portfolio import make_strategy
        from ..core.strategies import strategy_label
        from ..core.transform import transform
        from .engines import resolve_engine
        from .levelset import resolve_device
        from .schedule import schedule_for_transformed

        if tune == "auto":
            raise NotImplementedError(
                "tune='auto' needs the strategy-portfolio tuner, which the "
                "port does not have yet (ROADMAP.md, queue 1: tuner); pass "
                "a strategy name such as 'avgLevelCost'")
        if side not in ("lower", "upper"):
            raise ValueError(f"side must be 'lower' or 'upper', got {side!r}")
        dev = resolve_device(device)
        eng = resolve_engine(engine, device=dev)
        if dev.type not in getattr(eng, "device_types", (dev.type,)):
            raise ValueError(f"engine {eng.name!r} does not run on {dev}; "
                             f"it runs on {tuple(eng.device_types)}")
        strat = make_strategy(tune)
        label = strategy_label(strat)
        cfg = {"tune": label, "side": side, "transpose": bool(transpose),
               "chunk": chunk, "max_deps": max_deps,
               "dtype": np.dtype(dtype).name}
        build_kwargs = {"side": side, "transpose": bool(transpose),
                        "chunk": chunk, "max_deps": max_deps, "dtype": dtype,
                        "engine": eng, "device": dev, "cache": cache}
        key = (matrix_fingerprint(L, include_values=False) + "-" +
               hashlib.sha256(repr(sorted(cfg.items())).encode()
                              ).hexdigest()[:16] + "-" +
               value_fingerprint(L))

        def _finish(payload, source):
            op = cls(L, payload, cache_source=source, device=dev, engine=eng)
            op._build_kwargs = dict(build_kwargs, tune=tune)
            return op

        if cache:
            payload = cls._memory_get(key)
            if payload is not None:
                return _finish(payload, "memory")
        L_eff, reversed_ = orient_lower(L, side, bool(transpose))
        t0 = time.perf_counter()
        ts = transform(L_eff, strat, validate=False, codegen=False)
        sched = schedule_for_transformed(ts, chunk=chunk, max_deps=max_deps,
                                         dtype=dtype)
        payload = {"version": CACHE_VERSION, "strategy": label, "ts": ts,
                   "sched": sched, "config": cfg, "reversed": reversed_,
                   "tune_ms": (time.perf_counter() - t0) * 1e3}
        if cache:
            cls._memory_put(key, payload)
        return _finish(payload, "built")

    def transposed(self) -> "TriangularOperator":
        """The adjoint operator: same stored triangle, flipped sweep, same
        device and engine.  Goes through from_csr, so it shares the cache.
        """
        kw = dict(self._build_kwargs)
        kw["transpose"] = not kw["transpose"]
        tune = kw.pop("tune")
        return TriangularOperator.from_csr(self._L, tune, **kw)

    # -- solving --------------------------------------------------------------
    @property
    def n(self) -> int:
        return self._L.n_rows

    @property
    def schedule(self):
        return self._sched

    def _staged(self):
        ds = self._runtime.get("dsched")
        if ds is None:
            from .levelset import to_device
            ds = self._runtime["dsched"] = to_device(self._sched, self.device)
        return ds

    def _compiled_fn(self, engine):
        """engine -> compiled schedule fn, cached on the shared payload."""
        cached = self._runtime["compiled"].get(engine.name)
        if cached is not None and cached[0] is engine:
            return cached[1]
        fn = engine.compile(self._staged())
        self._runtime["compiled"][engine.name] = (engine, fn)
        return fn

    def _schedule_dtype(self) -> torch.dtype:
        from .levelset import torch_dtype
        return torch_dtype(self._sched.dtype)

    def _device_solve(self, c: np.ndarray, engine) -> np.ndarray:
        """One schedule execution in the schedule dtype."""
        ct = torch.as_tensor(np.ascontiguousarray(c),
                             dtype=self._schedule_dtype(), device=self.device)
        return self._compiled_fn(engine)(ct).cpu().numpy()

    def _preamble_host(self):
        """(LevelSchedule|None, src, row_pos) for the T-factor preamble,
        compiled once on the shared payload (None = identity preamble)."""
        entry = self._payload.get("_preamble_host")
        if entry is None:
            from .schedule import schedule_for_preamble
            entry = self._payload["_preamble_host"] = schedule_for_preamble(
                self._ts, chunk=self._config["chunk"],
                max_deps=self._config["max_deps"],
                dtype=np.dtype(self._config["dtype"]))
        return entry

    def _preamble_staged(self):
        """_preamble_host staged on this operator's device, once: (staged
        schedule|None, src tensor|None, row_pos tensor|None)."""
        entry = self._runtime.get("preamble")
        if entry is None:
            from .levelset import to_device
            psched, src, row_pos = self._preamble_host()
            if psched is None:
                entry = (None, None, None)
            else:
                entry = (to_device(psched, self.device),
                         torch.as_tensor(src, device=self.device),
                         torch.as_tensor(row_pos, device=self.device))
            self._runtime["preamble"] = entry
        return entry

    def device_solve_fn(self, engine=None):
        """The operator's sweep as a tensor -> tensor callable on the
        operator's device.

        Returns fn(v) -> x for v of shape (n,) or (n, k): axis reversal
        (transpose/upper sweeps), the T-factor preamble (a second level
        schedule through the SAME engine, via schedule_for_preamble), and
        the main schedule all run on the device in the schedule dtype; the
        result is cast back to v's dtype.  No float64 refinement and no
        health checks — the raw device pipeline.
        """
        from .engines import resolve_engine
        eng = self._engine if engine is None else \
            resolve_engine(engine, device=self.device)
        main_fn = self._compiled_fn(eng)
        pdsched, src, row_pos = self._preamble_staged()
        pre_fn = None
        if pdsched is not None:
            cached = self._runtime["pre_compiled"].get(eng.name)
            if cached is not None and cached[0] is eng:
                pre_fn = cached[1]
            else:
                pre_fn = eng.compile(pdsched)
                self._runtime["pre_compiled"][eng.name] = (eng, pre_fn)
        return compose_sweep_fn(main_fn, self._schedule_dtype(), pre_fn,
                                src, row_pos, self._reversed)

    def _oriented_solve(self, v: np.ndarray, engine,
                        out_dtype=None) -> np.ndarray:
        """Device solve of the oriented system for an original-orientation
        right-hand side v: reverse, host preamble, schedule, un-reverse.

        out_dtype=None returns the schedule dtype's natural output (the
        no-refinement path); the refinement loop passes float64 so
        corrections accumulate at full precision."""
        if self._reversed:
            v = v[::-1]
        x = self._device_solve(self._ts.preamble(v), engine)
        if out_dtype is not None:
            x = x.astype(out_dtype)
        return x[::-1] if self._reversed else x

    def _relative_residual(self, b, x) -> float:
        b64 = np.asarray(b, dtype=np.float64)
        r = b64 - self._L.matvec(np.asarray(x, dtype=np.float64),
                                 transpose=self.transpose)
        scale = max(1.0, float(np.abs(b64).max(initial=0.0)))
        return float(np.abs(r).max(initial=0.0)) / scale

    def solve(self, b: np.ndarray, *, engine=None,
              refine_tol: float = 1e-10, max_refine: int = 6,
              health=None) -> np.ndarray:
        """Solve the operator's sweep (L, L^T, U, or U^T) x = b for b of
        shape (n,) or batched (n, k), as numpy arrays on the host.

        Runs the preamble + compiled schedule in the schedule dtype, then
        iteratively refines in float64 against the original matrix until
        the relative residual max|b - Ax| / max(1, max|b|) <= refine_tol
        (or max_refine correction rounds).  Refined solves return float64.
        max_refine=0 skips refinement and returns the schedule dtype's
        output (float32 by default).

        health: a HealthPolicy, a named level ("off" | "on" | "strict"), or
        None for the REPRO_HEALTH_CHECKS default ("on").  A violation
        raises NumericalHealthError.
        """
        from ..core.resilience import (NumericalHealthError, SolveGuard,
                                       resolve_health_policy)
        from .engines import resolve_engine
        eng = self._engine if engine is None else \
            resolve_engine(engine, device=self.device)
        policy = resolve_health_policy(health)
        guard = SolveGuard(policy, where=f"TriangularOperator(n={self.n}, "
                                         f"engine={eng.name!r})")
        b = np.asarray(b, dtype=np.float64) if max_refine > 0 \
            else np.asarray(b)
        if b.ndim not in (1, 2) or b.shape[0] != self.n:
            raise ValueError(f"b must be ({self.n},) or ({self.n}, k), "
                             f"got {b.shape}")
        guard.require_finite_input(b)
        t0 = time.perf_counter()
        resid = float("nan")
        rounds = 0
        x = self._oriented_solve(
            b, eng, out_dtype=np.float64 if max_refine > 0 else None)
        if max_refine > 0:
            bscale = max(1.0, float(np.abs(b).max(initial=0.0)))
            while True:
                r = b - self._L.matvec(x, transpose=self.transpose)
                resid = float(np.abs(r).max(initial=0.0)) / bscale
                if not np.isfinite(resid):
                    break           # poisoned: the output check raises
                if resid <= refine_tol or rounds >= max_refine:
                    break
                x = x + self._oriented_solve(r, eng, out_dtype=np.float64)
                rounds += 1
        reason, stage = guard.output_unhealthy(x), "output"
        if reason is None and policy.residual_check:
            if not np.isfinite(resid):      # unset (max_refine=0)
                resid = self._relative_residual(b, x)
            reason, stage = guard.residual_unhealthy(resid), "residual"
        if reason is not None:
            self.stats.record_health_event(f"{stage}:raised")
            raise NumericalHealthError(reason, stage=stage,
                                       where=guard.where)
        self.stats.record_solve(
            ms=(time.perf_counter() - t0) * 1e3,
            columns=1 if b.ndim == 1 else b.shape[1], rounds=rounds,
            residual=resid)
        return x

    def __repr__(self) -> str:  # pragma: no cover
        return (f"TriangularOperator(n={self.n}, side={self.side!r}, "
                f"transpose={self.transpose}, strategy={self.strategy!r}, "
                f"steps={self._sched.num_steps}, engine={self.engine!r}, "
                f"device={self.device}, cache={self.stats.cache_source})")
