"""TriangularOperator: cached end-to-end SpTRSV facade on torch devices.

Port of `repro.solver.operator`:

    op = TriangularOperator.from_csr(L)             # tuned, on "cuda"
    op = TriangularOperator.from_csr(L, tune="avgLevelCost", device="cpu")
    x  = op.solve(b)                                # b: (n,) or (n, k)
    f  = op.device_solve_fn()                       # tensor -> tensor

`from_csr` orients the sweep to a lower-triangular system, runs the
strategy-portfolio tuner (`tune="auto"`, the default; `op.report` holds
its ranked report) or the graph transformation for the named strategy,
compiles the width-bucketed LevelSchedule (the numpy host half, copied
from `repro`), and caches the artifact in memory and on disk
(REPRO_TORCH_CACHE_DIR or ~/.cache/repro-torch-sptrsv).  The schedule is
staged once per device; the engine is the CUDA kernel on a card and the
plain PyTorch body on the CPU.  The device is `cuda` unless the caller
passes `device="cpu"`; without CUDA and without `device=`, construction
raises.

The cache key is a PATTERN segment (sparsity structure + configuration)
and a VALUE segment (`torch-op-{pattern}-{config}-{values}.pkl`).  A
`from_csr` whose pattern and configuration match a cached artifact but
whose values differ derives the new payload through the value-update
fast path (`cache_source == "pattern"`) instead of re-tuning, and
`op.update_values(new_L)` is its in-place form for time-stepping loops:
`replay_transform` re-runs the frozen transformation's eliminations,
`repack_schedule_values` refills the schedules, and on the card the SpTRSV
kernel's packed tiles are refreshed on the device
(`kernels.sptrsv_level.refresh_packed_values`); they are packed anew only
when the set of coefficients that are 0 in float32 moved.  A changed
pattern raises `PatternMismatchError`.

The disk tier is the port's own: its directory, file prefix and
CACHE_VERSION differ from the reference's, whose entries unpickle into
the reference's classes (and through them jax).  An entry holds host
data only: the transform, the schedules (main and T-factor preamble),
the slim tuner report, the configuration and, for an operator built on a
card, both schedules' packed forms with their value maps, so a hit on
the card packs nothing.  Writes are atomic (a uniquely named temporary
sibling, then `os.replace`); an entry that fails to load (corrupt bytes,
stale CACHE_VERSION) is moved to a `.bad/` sibling directory with a
`CacheQuarantineWarning` and the artifact is rebuilt.

All four triangular sweeps share one lower-triangular pipeline:
`side="lower"|"upper"` selects the stored triangle, `transpose=True`
solves with its transpose; `op.transposed()` is the adjoint operator.

`solve` runs the T-factor preamble on the host, the compiled schedule on
the device in the schedule dtype (float32 by default), then iteratively
refines in float64 on the host against the ORIGINAL matrix.  It runs
under a `SolveGuard`: a non-finite right-hand side raises
`NumericalHealthError`; a non-finite solution or (under
`health="strict"`) a large residual raises it too, unless the policy
repairs (`"repair"`: refinement through the operator's own engine) or
falls back (`"fallback"`, and `"repair"` when refinement fails: the
float64 host reference solve built from the original matrix, always with
a `HealthRepairWarning`).  The host reference serves CPU-staged
operators only: on a card the kernel serves the solve or it raises,
under every policy.  The first solve and every refinement correction go
through the engine's fallback chain (`engines.engine_fallbacks`), which
is empty for both of the port's engines and never holds the plain engine
on a card, so on the card a dead chain raises `EngineFallbackError`.
What an engine's `available()` or `compile()` raises is memoized on the
payload; what its compiled callable raises is not, so one failed launch
does not stop an operator from serving.

Static verification (`repro_torch.analysis`): under a health policy with
`verify_schedule` (`health="strict"`), `from_csr` audits the transformed
system and certifies the compiled schedule once per built payload, before
anything is packed, staged or stored, and on a card certifies the SpTRSV
kernel's packed forms of the main and preamble schedules (what the kernel
reads: tiles, far pairs, free pass) before the first launch; the
`ScheduleCertificate` and the `PackedCertificate`s ride the payload into
both cache tiers, so a hit that carries them re-verifies nothing.
`update_values(..., health="strict")` re-audits what a value re-bind
changed (the replayed transform, the schedule's values, and on the card
the refreshed packed words) before the operator mutates or anything is
cached.  A failed certification raises `ScheduleInvariantError` /
`TransformInvariantError`; nothing is launched from a defective artifact.
`op.certificate` and `op.verify()` expose it.

`op.stats` is a view over a metrics registry (`repro_torch.obs`), and
the build, the value update, the engine compile and the solve open the
reference's spans (`operator.tune`, `operator.update_values`,
`engine.compile`, `operator.solve`, `engine.solve`, `operator.refine`)
and events (`operator.cache`, `engine.fallback`, `health.violation`)
when tracing is on.

Sharded sweeps (`mesh=`, a torch.distributed DeviceMesh with the axis
`mesh_axis`): every solve goes through the `ShardedEngine` over that axis,
one all_gather family per schedule step (`solver/distributed.py`), on the
mesh's device.  Every rank builds the same operator and solves the same
right-hand side, and gets the same x.  The engine lowers from the host
schedule: a sharded operator never stages the unpadded schedule and never
packs the SpTRSV kernel's tiles; its chain falls back to K1 on a card
(which packs them at that first use) and to the plain body on the CPU.
Under a mesh of more than one rank only the axis' first rank writes the
disk tier.
"""
from __future__ import annotations

import collections
import hashlib
import os
import pickle
import threading
import time
import uuid
import warnings
from pathlib import Path

import numpy as np
import torch

from ..obs import trace as _obs
from ..obs.metrics import MetricsRegistry
from ..sparse.csr import CSR, reverse_both

__all__ = ["TriangularOperator", "OperatorStats", "matrix_fingerprint",
           "value_fingerprint", "default_cache_dir", "orient_lower",
           "compose_sweep_fn", "candidate_sweep_fn"]

# the port's own: never equal to the reference's (an int), so that neither
# package would take the other's entry for a current one
CACHE_VERSION = "repro_torch-1"
CACHE_PREFIX = "torch-op-"      # the reference's entries are "op-*.pkl"


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


def candidate_sweep_fn(ts, sched, engine, device, reversed_: bool = False):
    """A transformed system's sweep as `device_solve_fn` serves it: the
    T-factor preamble's schedule (`schedule_for_preamble`, with `sched`'s
    compile settings) and `sched`, staged on `device` and compiled by
    `engine`, composed by `compose_sweep_fn`.  What the tuner's measured
    modes time."""
    from .levelset import to_device, torch_dtype
    from .schedule import schedule_for_preamble
    main_fn = engine.compile(to_device(sched, device))
    psched, src, row_pos = schedule_for_preamble(
        ts, chunk=sched.chunk, max_deps=sched.max_deps, dtype=sched.dtype)
    pre_fn = None
    if psched is not None:
        pre_fn = engine.compile(to_device(psched, device))
        src = torch.as_tensor(src, device=device)
        row_pos = torch.as_tensor(row_pos, device=device)
    return compose_sweep_fn(main_fn, torch_dtype(sched.dtype), pre_fn, src,
                            row_pos, reversed_)


def default_cache_dir() -> Path:
    """REPRO_TORCH_CACHE_DIR env override, else ~/.cache/repro-torch-sptrsv
    (the reference's is REPRO_CACHE_DIR or ~/.cache/repro-sptrsv)."""
    env = os.environ.get("REPRO_TORCH_CACHE_DIR")
    if env:
        return Path(env)
    return Path(os.path.expanduser("~/.cache")) / "repro-torch-sptrsv"


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
    """Per-operator stats plane: a VIEW over a `repro_torch.obs` metrics
    registry (prefix "repro_operator"), updated by every solve().

    Every field is backed by one instrument — Counter, Gauge, or Text —
    in `self.registry`, with the reference's names, helps and `to_dict()`
    order; reading a field reads the instrument, and Prometheus/JSON
    export reads the SAME instruments, so there is no second ledger.
    Updates are atomic per event: each record_* call commits its
    instruments under the registry's one shared lock, so concurrent
    `solve()` calls from a serving tier's worker threads never interleave
    a half-written record.  The record methods are the reference's;
    `repacks` (the port's own counter, outside `to_dict()`) counts the
    value updates whose new zero set made the SpTRSV kernel's packing run
    anew.
    """

    _COUNTER_FIELDS = (
        ("solves", "host solve() calls completed"),
        ("rhs_columns", "right-hand-side columns solved"),
        ("refine_rounds", "iterative-refinement correction rounds"),
        ("value_updates", "update_values() calls served"),
        ("fallbacks", "downgraded engine dispatches (attempts)"),
        ("fallback_downgrades", "unique requested->used engine downgrades"),
        ("health_events", "health violations detected"),
        ("repacks", "value updates that packed the SpTRSV kernel's "
                    "schedule anew (float32 zero set moved)"),
    )
    _GAUGE_FIELDS = (
        ("total_solve_ms", 0.0, "cumulative solve wall time (ms)"),
        ("last_solve_ms", 0.0, "wall time of the last solve (ms)"),
        ("last_residual", float("nan"),
         "relative residual of the last solve"),
        ("tune_ms", 0.0, "wall time of the tuner run behind the payload"),
        ("last_update_ms", 0.0, "wall time of the last value update (ms)"),
    )
    _TEXT_FIELDS = (
        # "built" | "memory" | "disk" | "pattern" (payload derived from
        # an equal-pattern artifact via the refactorization fast path)
        ("cache_source", "how the payload was obtained"),
        ("last_fallback", "last downgrade as requested->used"),
        ("last_health_event", "last health event as stage:action"),
    )
    _FIELDS = ("solves", "rhs_columns", "refine_rounds", "total_solve_ms",
               "last_solve_ms", "last_residual", "cache_source", "tune_ms",
               "value_updates", "last_update_ms", "fallbacks",
               "fallback_downgrades", "last_fallback", "health_events",
               "last_health_event")

    def __init__(self, cache_source: str = "built", tune_ms: float = 0.0,
                 registry: MetricsRegistry | None = None):
        self.registry = registry if registry is not None else \
            MetricsRegistry(prefix="repro_operator")
        r = self.registry
        self._lock = r.lock
        self._inst = {}
        for name, help in self._COUNTER_FIELDS:
            self._inst[name] = r.counter(name, help)
        for name, default, help in self._GAUGE_FIELDS:
            self._inst[name] = r.gauge(name, help, default=default)
        for name, help in self._TEXT_FIELDS:
            self._inst[name] = r.text(name, help)
        self._inst["cache_source"].set(cache_source)
        self._inst["tune_ms"].set(float(tune_ms))

    def to_dict(self) -> dict:
        with self._lock:
            return {name: self._inst[name].value() for name in self._FIELDS}

    # -- atomic mutation (one lock acquisition per event) ---------------------
    def record_solve(self, *, ms: float, columns: int, rounds: int,
                     residual: float) -> None:
        with self._lock:
            self._inst["solves"].inc()
            self._inst["rhs_columns"].inc(columns)
            self._inst["refine_rounds"].inc(rounds)
            self._inst["total_solve_ms"].add(ms)
            self._inst["last_solve_ms"].set(ms)
            self._inst["last_residual"].set(residual)

    def record_value_update(self, *, ms: float, cache_source: str,
                            repacks: int = 0) -> None:
        with self._lock:
            self._inst["value_updates"].inc()
            self._inst["last_update_ms"].set(ms)
            self._inst["cache_source"].set(cache_source)
            self._inst["repacks"].inc(repacks)

    def record_fallback(self, last: str, *, new_pair: bool = False) -> None:
        """One downgraded dispatch; `new_pair` marks the first sighting of
        this (requested, used) pair."""
        with self._lock:
            self._inst["fallbacks"].inc()
            if new_pair:
                self._inst["fallback_downgrades"].inc()
            self._inst["last_fallback"].set(last)

    def record_health_event(self, last: str = "") -> None:
        with self._lock:
            self._inst["health_events"].inc()
            if last:
                self._inst["last_health_event"].set(last)

    def record_health_action(self, last: str) -> None:
        self._inst["last_health_event"].set(last)

    def __repr__(self) -> str:    # pragma: no cover
        return "OperatorStats(" + ", ".join(
            f"{k}={v!r}" for k, v in self.to_dict().items()) + ")"


def _stats_field_property(name: str) -> property:
    """Read access to one OperatorStats field: its backing instrument."""
    return property(lambda self: self._inst[name].value())


for _name, *_rest in (OperatorStats._COUNTER_FIELDS
                      + OperatorStats._GAUGE_FIELDS
                      + OperatorStats._TEXT_FIELDS):
    setattr(OperatorStats, _name, _stats_field_property(_name))
del _name, _rest


def _payload_preamble(payload: dict):
    """(LevelSchedule|None, src, row_pos) of the payload's T-factor
    preamble, compiled once and kept on it (persisted)."""
    entry = payload.get("preamble")
    if entry is None:
        from .schedule import schedule_for_preamble
        cfg = payload["config"]
        entry = payload["preamble"] = schedule_for_preamble(
            payload["ts"], chunk=cfg["chunk"], max_deps=cfg["max_deps"],
            dtype=np.dtype(cfg["dtype"]))
    return entry


def _payload_packed(payload: dict, which: str):
    """The payload's packed form of its main schedule ("packed") or of its
    preamble's ("preamble_packed"; None for an identity preamble), packed
    on the host once and kept on it (persisted).  It lies where it was
    last moved to: on the host after a pack or a disk load, on the card
    once an operator there staged it."""
    packed = payload.get(which)
    if packed is None:
        from ..kernels.sptrsv_level import pack_schedule
        sched = payload["sched"] if which == "packed" else \
            _payload_preamble(payload)[0]
        if sched is None:
            return None
        packed = payload[which] = pack_schedule(sched)
    return packed


def _certify(payload: dict, device, where: str, *, base=None,
             refreshed=None) -> None:
    """Everything strict health certifies in a payload, in one place; it
    raises ScheduleInvariantError / TransformInvariantError.

    The host side: a payload re-bound to new values from `base` gets the
    value re-audit (the replayed transform, and the schedule's values
    against its A' and diagonal; the structure is the base's), as the
    reference's update_values does; any other that
    carries no certificate gets the full one, once
    (`verify_operator_payload`).  `refreshed` given means
    the re-bind that made the payload ran the host side before it
    refreshed its packed forms, so it is not repeated.

    On a card (`device` None: the host side only) the packed forms the
    kernel reads, main and preamble, kept under
    payload["packed_certificate"] (None for an identity preamble).  A form
    that a re-bind refreshed on the device (`refreshed[which]` False) from
    a certified form of `base` (its structure and value map certified in
    full, at its build or at the re-bind it came from) has its rewritten
    words read back (`verify_packed_values`); every other one without a certificate is
    packed where the payload has none and certified in full, the
    preamble's LevelSchedule (unit diagonal) before its pack."""
    from ..analysis import verify as V
    if refreshed is None:
        if base is not None:
            V.audit_transformed_system(payload["ts"], where=where)
            V.verify_schedule_values(payload["sched"], payload["ts"].A,
                                     payload["ts"].diag, where=where)
        elif "certificate" not in payload:
            V.verify_operator_payload(payload, where=where)
    if device is None or device.type != "cuda":
        return
    certs = dict(payload.get("packed_certificate") or {})
    base_certs = (base or {}).get("packed_certificate") or {}
    for which, again in (refreshed or {}).items():
        if again or base_certs.get(which) is None:
            certs.pop(which, None)
        else:
            sched = payload["sched"] if which == "packed" else \
                payload["preamble"][0]
            certs[which] = V.verify_packed_values(payload[which], sched,
                                                  where=where)
    for which in ("packed", "preamble_packed"):
        if which in certs:
            continue
        if which == "packed":
            sched = payload["sched"]
        else:
            sched = _payload_preamble(payload)[0]
            if sched is None:
                certs[which] = None
                continue
            V.verify_level_schedule(sched, None, np.ones(sched.n),
                                    where=where)
        certs[which] = V.verify_packed_schedule(
            _payload_packed(payload, which), sched, where=where)
    payload["packed_certificate"] = certs


def _schedule_digest(payload: dict) -> tuple:
    """What every rank of a sharded solve must share: the strategy and the
    schedule's structure (each group's lane shape and carries), which fix
    every step's collectives."""
    sched = payload["sched"]
    return (payload["strategy"], sched.n_carry,
            tuple((g.row_ids.shape, g.dep_idx.shape[2],
                   g.carry_in is not None) for g in sched.groups))


def _agreed_hit(engine, payload):
    """`payload` when every rank of `engine`'s mesh holds a cache hit of
    the same schedule, else None, so that the ranks serve one hit together
    or all build (or derive) together, never one of each: a rank building
    alone would tune, and its measured mode's broadcast would wait for
    ranks that never join it.  On one device, `payload` itself."""
    mine = None if payload is None else _schedule_digest(payload)
    hits = engine.all_ranks(mine)
    return payload if mine is not None and all(h == mine for h in hits) \
        else None


class TriangularOperator:
    """Compiled triangular-solve operator for one matrix (see module doc)."""

    # bounded LRU: payloads hold full transforms + ELL tiles (MB-scale per
    # large matrix), so a long-lived process over many matrices must not
    # accumulate them forever; overflow falls back to the disk cache
    _memory_cache_max: int = 16
    _memory_cache = collections.OrderedDict()
    # pattern segment of the key ("{pattern32}-{config16}") -> latest full
    # key stored: lets from_csr find an equal-pattern payload to derive
    # from without scanning the LRU
    _pattern_index: dict = {}
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
            cls._pattern_index[key.rsplit("-", 1)[0]] = key
            while len(cls._memory_cache) > cls._memory_cache_max:
                cls._memory_cache.popitem(last=False)

    @classmethod
    def _memory_get_pattern(cls, pattern_key: str):
        """Newest in-memory payload whose pattern+config segment matches
        (one lock acquisition for index lookup + LRU touch)."""
        with cls._cache_lock:
            return cls._memory_get(cls._pattern_index.get(pattern_key, ""))

    @classmethod
    def clear_memory_cache(cls) -> None:
        with cls._cache_lock:
            cls._memory_cache.clear()
            cls._pattern_index.clear()

    def __init__(self, L: CSR, payload: dict, cache_source: str, *,
                 device: torch.device, engine):
        self._L = L                 # the ORIGINAL matrix, as handed in
        self._payload = payload     # update_values derives from + rebinds it
        self._ts = payload["ts"]    # transform of the oriented lower system
        self._sched = payload["sched"]
        self.report = payload.get("report")        # slim PortfolioReport|None
        self.strategy = payload["strategy"]        # winning strategy label
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
                 device=None, mesh=None, mesh_axis: str = "model",
                 cache: bool = True, cache_dir=None,
                 portfolio=None, cost_model=None,
                 measure_top_k: int = 0,
                 health=None) -> "TriangularOperator":
        """Build (or load) the operator for L.

        side/transpose: which sweep this operator performs (module doc).
        tune:   "auto" — run the StrategyPortfolio tuner and take its pick
                (`op.report` is its slim report); a stable strategy name
                ("avgLevelCost", ...) or a Strategy instance — skip tuning
                and use that strategy as-is.
        engine: a registered name ("cuda", "torch"), an Engine, or None for
                the device's default ("cuda" on a card, "torch" on the CPU).
        device: "cuda" (the default when None) or "cpu"; None without CUDA
                raises RuntimeError.  On a card the build also packs and
                stages the sweep's schedules (main and preamble).
        mesh/mesh_axis: serve sharded sweeps — a DeviceMesh routes every
                solve through the ShardedEngine over `mesh_axis` (one
                all_gather family per step; module doc), staged on the
                mesh's device (a `device=` that disagrees raises).
                Mutually exclusive with `engine=`.  With tune="auto" and
                no explicit cost_model, tuning defaults to
                `CostModel.sharded()`, which charges the per-step
                collective.
        cache:  look up / keep the compiled artifact in memory and on disk
                (memory, then disk, then an equal-pattern artifact of
                either re-bound to L's values: module doc), keyed by the
                matrix fingerprint and the configuration.
        cache_dir: the disk tier's directory (None: `default_cache_dir()`).
        cost_model: the tuner's constants (a portfolio CostModel; None:
                `default_cost_model_for(engine)`); part of the cache key.
                tune="auto" only.
        measure_top_k: time the tuner's k model-best candidates on the
                device as they would serve, and re-rank them.  "auto" only.
        portfolio: a fully custom StrategyPortfolio (tune="auto" only);
                cost_model/measure_top_k are forwarded when constructing
                the default one.  Its configuration is not part of the
                cache key, so passing one disables caching for that build.
        health: health policy spec (same forms as solve()'s `health=`).
                Under a policy with `verify_schedule` (the "strict" level),
                the static verifier certifies the compiled artifact ONCE
                per built payload — the `ScheduleCertificate` rides the
                cached payload, so cache hits skip re-verification — and
                on a card also the SpTRSV kernel's packed forms of it,
                before the first pack for a launch and before the disk
                store.  Not part of the cache key: verifying does not
                change the artifact.

        With tune="auto" the engine is part of the cache key: it says what
        a step costs (`Engine.sweep_shape`), so two engines may pick
        differently.
        """
        import dataclasses as _dc
        from ..core.portfolio import (StrategyPortfolio,
                                      default_cost_model_for, make_strategy)
        from ..core.resilience import resolve_health_policy
        from ..core.strategies import strategy_label
        from ..core.transform import transform
        from .engines import resolve_placement
        from .schedule import schedule_for_transformed

        if side not in ("lower", "upper"):
            raise ValueError(f"side must be 'lower' or 'upper', got {side!r}")
        eng, dev = resolve_placement(engine, device, mesh=mesh,
                                     mesh_axis=mesh_axis)
        if dev.type not in getattr(eng, "device_types", (dev.type,)):
            raise ValueError(f"engine {eng.name!r} does not run on {dev}; "
                             f"it runs on {tuple(eng.device_types)}")
        auto = isinstance(tune, str) and tune == "auto"
        if auto and cost_model is None:
            cost_model = default_cost_model_for(eng)
        cache = cache and portfolio is None
        tune_key = "auto" if auto else strategy_label(make_strategy(tune))
        cfg = {"tune": tune_key, "side": side, "transpose": bool(transpose),
               "chunk": chunk, "max_deps": max_deps,
               "dtype": np.dtype(dtype).name,
               "engine": eng.cache_token() if auto else None,
               "measure_top_k": measure_top_k,
               "cost_model": (None if cost_model is None
                              else sorted(_dc.asdict(cost_model).items()))}
        build_kwargs = {"side": side, "transpose": bool(transpose),
                        "chunk": chunk, "max_deps": max_deps, "dtype": dtype,
                        "engine": eng, "device": dev, "cache": cache,
                        "cache_dir": cache_dir, "portfolio": portfolio,
                        "cost_model": cost_model,
                        "measure_top_k": measure_top_k}
        pattern_key = cls._pattern_cache_key(L, cfg)
        key = f"{pattern_key}-{value_fingerprint(L)}"
        strict = resolve_health_policy(health).verify_schedule
        where = f"TriangularOperator.from_csr(n={L.n_rows})"
        # where K1's tiles are packed and certified: nowhere for an engine
        # that reads none (the sharded one)
        pack_dev = eng.pack_device(dev)

        def _finish(payload, source):
            if strict:
                # a hit without its certificates (built without strict
                # health, or an older disk entry) is certified now, before
                # the card packs or launches anything from it
                _certify(payload, pack_dev, where)
            op = cls(L, payload, cache_source=source, device=dev, engine=eng)
            op._build_kwargs = dict(build_kwargs, tune=tune)
            if dev.type == "cuda" or eng.collective_mesh() is not None:
                # stage (on a card, pack) the forms of the sweep's
                # schedules the engine reads now, so the build and not the
                # first solve pays the host packing; what packing and
                # staging raise fails the build.  A sharded engine lowers
                # here, every rank together.  What the engine's compile
                # raises (a capability check, a failed build of the
                # kernels, a lost mesh) is memoized as a compile failure:
                # the solves walk the engine's chain and name it
                eng.operator_form(op)
                eng.operator_form(op, "preamble")
                try:
                    op.device_solve_fn()
                except Exception as e:  # noqa: BLE001 - named at solve
                    op._remember_failure(eng, e)
            _obs.event("operator.cache", source=source, n=L.n_rows,
                       strategy=payload["strategy"])
            return op

        payload, source = None, None
        if cache:
            payload, source = cls._memory_get(key), "memory"
            if payload is None:
                payload, source = cls._disk_load(key, cache_dir), "disk"
            if payload is None:
                # no exact hit: an equal-pattern artifact (any values) can
                # be numerically re-bound without re-tuning or re-compiling
                base = cls._memory_get_pattern(pattern_key)
                if base is None:
                    base = cls._disk_load_pattern(pattern_key, cache_dir)
                if base is not None:
                    # under strict health the re-bound schedule is
                    # certified before its packed forms are refreshed
                    payload, source = cls._try_derive_payload(
                        base, L, certify=strict, where=where), "pattern"
        payload = _agreed_hit(eng, payload)
        if payload is not None:
            if source == "pattern" and strict:
                _certify(payload, pack_dev, where)     # the packed forms
            if source != "memory":
                cls._memory_put(key, payload)
            if source == "pattern" and eng.writes_disk():
                cls._disk_store(key, payload, cache_dir)
            return _finish(payload, source)
        L_eff, reversed_ = orient_lower(L, side, bool(transpose))
        t0 = time.perf_counter()
        report = None
        with _obs.span("operator.tune", n=L.n_rows, tune=tune_key):
            if auto:
                tuner = portfolio if portfolio is not None else \
                    StrategyPortfolio(chunk=chunk, max_deps=max_deps,
                                      dtype=dtype, cost_model=cost_model,
                                      measure_top_k=measure_top_k,
                                      engine=eng, device=dev)
                report = tuner.tune(L_eff)
                best = report.best
                ts, sched, label = best.ts, best.sched, best.label
                report = report.slim()  # candidates keep stats, drop arrays
            else:
                strat = make_strategy(tune)
                label = strategy_label(strat)
                ts = transform(L_eff, strat, validate=False, codegen=False)
                sched = schedule_for_transformed(ts, chunk=chunk,
                                                 max_deps=max_deps,
                                                 dtype=dtype)
        payload = {"version": CACHE_VERSION, "strategy": label, "ts": ts,
                   "sched": sched, "report": report, "config": cfg,
                   "reversed": reversed_,
                   "tune_ms": (time.perf_counter() - t0) * 1e3}
        if strict:
            # certified BEFORE anything is packed or persisted: a defective
            # schedule raises a typed error with no pack and no launch, and
            # the certificates ride the disk entry, so _finish has nothing
            # to do; on a card this packs and certifies the packed forms
            _certify(payload, pack_dev, where)
        elif pack_dev is not None and pack_dev.type == "cuda":
            # packed before the disk store, so that the entry carries the
            # packed forms and a later hit on a card packs nothing
            for which in ("packed", "preamble_packed"):
                _payload_packed(payload, which)
        if cache:
            cls._memory_put(key, payload)
            if eng.writes_disk():
                cls._disk_store(key, payload, cache_dir)
        return _finish(payload, "built")

    def transposed(self) -> "TriangularOperator":
        """The adjoint operator: same stored triangle, flipped sweep, same
        device and engine.  Goes through from_csr, so it shares the cache.
        """
        kw = dict(self._build_kwargs)
        kw["transpose"] = not kw["transpose"]
        tune = kw.pop("tune")
        return TriangularOperator.from_csr(self._L, tune, **kw)

    # -- pattern-frozen value updates -----------------------------------------
    @classmethod
    def _derive_payload(cls, base: dict, L_new: CSR, *, certify=False,
                        where="TriangularOperator.update_values") -> tuple:
        """Re-bind an equal-pattern payload to new numeric values:
        (payload, repacked), `repacked` mapping each packed form the
        payload holds ("packed", "preamble_packed") to whether it was
        packed anew.

        Reuses everything structure-derived from `base` — level analysis,
        the winning strategy's transformation (replayed numerically via its
        commit log), the schedules' layout and, where `base` holds them,
        the SpTRSV kernel's packed tiles, whose values are refreshed where
        they lie (on the card: device scatters, no host re-pack).  A packed
        schedule whose zero set moved is packed anew; `repacks` counts
        those.  Raises PatternMismatchError if the new values make the
        replayed transformation's pattern drift (exact cancellation
        creating/removing fill), ValueError if `base` predates the plans.
        With `certify` (strict health) the host side of `_certify` runs
        on the re-bound transform and schedules, at `where`, before any
        packed form is refreshed or packed anew; it raises.
        The new payload starts with no staged state of its own.
        """
        from ..core.transform import replay_transform
        from ..kernels.sptrsv_level import refresh_packed_values
        from .schedule import repack_schedule_values, schedule_for_preamble
        cfg = base["config"]
        L_eff, reversed_ = orient_lower(L_new, cfg["side"],
                                        bool(cfg["transpose"]))
        ts_new = replay_transform(L_eff, base["ts"],
                                  where="TriangularOperator.update_values")
        sched_new = repack_schedule_values(base["sched"], ts_new.A.data,
                                           ts_new.diag)
        payload = {"version": CACHE_VERSION, "strategy": base["strategy"],
                   "ts": ts_new, "sched": sched_new,
                   "report": base.get("report"), "config": cfg,
                   "reversed": reversed_,
                   "tune_ms": base.get("tune_ms", 0.0)}
        # the preamble schedule (solve with the T factor) is value-bound
        # too; repack it from the base entry when its value plan survived
        # renumbering.  If the base never materialized it, stay lazy — the
        # operator's _preamble_host builds it from the NEW transform on
        # first use, so the update itself never enters build_schedule.
        entry = base.get("preamble")
        refresh = {"packed": sched_new}
        if entry is not None:
            psched = entry[0]
            if psched is None:
                payload["preamble"] = entry
            elif psched.value_plan is not None:
                payload["preamble"] = (
                    repack_schedule_values(psched, ts_new.T.data,
                                           np.ones(ts_new.T.n_rows)),
                    entry[1], entry[2])
                refresh["preamble_packed"] = payload["preamble"][0]
            else:
                payload["preamble"] = schedule_for_preamble(
                    ts_new, chunk=cfg["chunk"], max_deps=cfg["max_deps"],
                    dtype=np.dtype(cfg["dtype"]))
        if certify:
            _certify(payload, None, where, base=base)
        repacked = {}
        for which, sched in refresh.items():
            if base.get(which) is not None:
                payload[which], repacked[which] = refresh_packed_values(
                    base[which], sched)
        return payload, repacked

    @classmethod
    def _try_derive_payload(cls, base: dict, L_new: CSR, **certify
                            ) -> dict | None:
        """_derive_payload for opportunistic from_csr use: a pattern drift
        or a pre-plan payload means "can't fast-path", not an error — the
        caller falls through to a full build.  A failed certification
        raises."""
        from ..core.resilience import PatternMismatchError
        try:
            return cls._derive_payload(base, L_new, **certify)[0]
        except (PatternMismatchError, ValueError):
            return None

    def update_values(self, new_L: CSR, *, health=None) -> "TriangularOperator":
        """Re-bind this operator to new numeric values on the SAME pattern.

        The refactorization fast path for time-stepping / Newton loops
        where the sparsity pattern is fixed and values change every step:
        level analysis, the graph transformation, the tuner's pick and the
        schedules' layout are all reused — only the numeric payload is
        re-derived (transform replay, schedule value repack and, on the
        card, a device refresh of the SpTRSV kernel's packed tiles).  No
        SpTRSV kernel runs until the next solve.  A value set whose float32
        zeros differ from the frozen packing's re-packs on the host and
        counts in `stats.repacks`.

        Mutates the operator in place and returns self.  A matrix whose
        pattern differs from the frozen one raises PatternMismatchError
        (rebuild with from_csr instead); non-finite values raise
        NumericalHealthError under any health policy that checks inputs
        (`health=` accepts the same specs as solve()).  Under a policy with
        `verify_schedule` ("strict"), the replayed transform is audited and
        the schedule's values re-verified before any packed form is
        refreshed, and on the card each refreshed packed form's rewritten
        words are read back and checked (`verify_packed_values`; a form
        packed anew, or a cache hit's uncertified one, is certified in
        full), all before the operator mutates or anything is cached; a
        violation raises ScheduleInvariantError / TransformInvariantError.
        """
        from ..core.resilience import (NumericalHealthError,
                                       PatternMismatchError,
                                       resolve_health_policy)
        from ..sparse.csr import same_pattern
        where = f"TriangularOperator.update_values(n={self.n})"
        if not same_pattern(new_L, self._L):
            if new_L.shape != self._L.shape:
                detail = f"shape {new_L.shape} != {self._L.shape}"
            elif new_L.nnz != self._L.nnz:
                detail = f"nnz {new_L.nnz} != {self._L.nnz}"
            elif not np.array_equal(new_L.indptr, self._L.indptr):
                detail = "row pointer drift"
            else:
                detail = "column index drift"
            raise PatternMismatchError(
                "matrix pattern differs from the frozen operator pattern; "
                "rebuild with from_csr", where=where, detail=detail)
        policy = resolve_health_policy(health)
        if policy.check_inputs and not np.all(np.isfinite(new_L.data)):
            raise NumericalHealthError(
                f"new matrix values contain non-finite entries in {where}",
                stage="input", where=where)
        t0 = time.perf_counter()
        with _obs.span("operator.update_values", n=self.n) as usp:
            cache = bool(self._build_kwargs.get("cache", False))
            cache_dir = self._build_kwargs.get("cache_dir")
            key = (f"{self._pattern_cache_key(new_L, self._config)}-"
                   f"{value_fingerprint(new_L)}")
            payload, source, repacked = None, "pattern", {}
            if cache:
                payload, source = self._memory_get(key), "memory"
                if payload is None:
                    payload, source = self._disk_load(key, cache_dir), "disk"
                payload = _agreed_hit(self._engine, payload)
                if payload is None:
                    source = "pattern"
                elif source == "disk":
                    self._memory_put(key, payload)
            derived = payload is None
            if derived:
                payload, repacked = self._derive_payload(
                    self._payload, new_L, certify=policy.verify_schedule,
                    where=where)
            if policy.verify_schedule:
                _certify(payload, self._pack_device(), where,
                         base=self._payload,
                         refreshed=repacked if derived else None)
            if derived and cache:
                self._memory_put(key, payload)
                if self._engine.writes_disk():
                    self._disk_store(key, payload, cache_dir)
            repacks = sum(repacked.values())
            usp.set(source=source, repacks=repacks)
        self._L = new_L
        self._payload = payload
        self._ts = payload["ts"]
        self._sched = payload["sched"]
        self._reversed = bool(payload["reversed"])
        self._runtime = payload.setdefault("_runtime", {}).setdefault(
            str(self.device), {"compiled": {}, "pre_compiled": {}})
        self.stats.record_value_update(
            ms=(time.perf_counter() - t0) * 1e3, cache_source=source,
            repacks=repacks)
        return self

    # -- static verification --------------------------------------------------
    @property
    def certificate(self):
        """The `ScheduleCertificate` this operator's payload carries, or
        None when it was never verified (build without strict health and
        no explicit verify() call)."""
        return self._payload.get("certificate")

    def verify(self, *, devices: int = 1, collectives: bool = False):
        """Run the full static verifier on the compiled artifact now.

        Audits the transformed system and certifies the schedule
        regardless of health policy, and on a card the packed forms the
        kernel reads; returns the `ScheduleCertificate` and keeps the
        certificates on the payload (so a later strict-mode cache hit
        skips re-verification).  Raises `ScheduleInvariantError` /
        `TransformInvariantError` on violation.  `collectives=True` also
        certifies one all_gather family per step of the sharded lowering
        (`verify_collectives`), over the operator's mesh when its engine
        is sharded, else over a mesh of one rank.
        """
        from ..analysis.verify import verify_operator_payload
        where = f"TriangularOperator.verify(n={self.n})"
        mesh, axis = None, "model"
        if collectives:
            mesh, axis = self._engine.collective_mesh() or (mesh, axis)
        cert = verify_operator_payload(
            self._payload, devices=devices, collectives=collectives,
            mesh=mesh, mesh_axis=axis, where=where)
        pack_dev = self._pack_device()
        if pack_dev is not None and pack_dev.type == "cuda":
            self._payload.pop("packed_certificate", None)
            _certify(self._payload, pack_dev, where)
        return cert

    # -- cache plumbing -------------------------------------------------------
    @classmethod
    def _pattern_cache_key(cls, L: CSR, cfg: dict) -> str:
        """Pattern+config segment of the cache key (values excluded)."""
        return (matrix_fingerprint(L, include_values=False) + "-" +
                hashlib.sha256(
                    repr(sorted(cfg.items())).encode()).hexdigest()[:16])

    @staticmethod
    def _cache_path(key: str, cache_dir) -> Path:
        d = Path(cache_dir) if cache_dir is not None else default_cache_dir()
        return d / f"{CACHE_PREFIX}{key}.pkl"

    @classmethod
    def _disk_load(cls, key: str, cache_dir) -> dict | None:
        return cls._disk_load_path(cls._cache_path(key, cache_dir))

    @classmethod
    def _disk_load_pattern(cls, pattern_key: str, cache_dir) -> dict | None:
        """Any healthy on-disk payload whose pattern+config segment matches
        (its values don't matter — the caller re-derives them).  The glob
        carries the port's prefix, so it never matches a reference entry."""
        d = Path(cache_dir) if cache_dir is not None else default_cache_dir()
        if not d.exists():
            return None
        for path in sorted(d.glob(f"{CACHE_PREFIX}{pattern_key}-*.pkl")):
            payload = cls._disk_load_path(path)
            if payload is not None:
                return payload
        return None

    @classmethod
    def _disk_load_path(cls, path: Path) -> dict | None:
        if not path.exists():
            return None
        try:
            with open(path, "rb") as f:
                payload = pickle.load(f)
            if payload.get("version") != CACHE_VERSION:
                cls._quarantine(
                    path, f"stale version {payload.get('version')!r} "
                    f"(expected {CACHE_VERSION!r})")
                return None
            return payload
        except Exception as e:          # corrupt entry: quarantine + rebuild
            cls._quarantine(path, f"unreadable ({type(e).__name__}: {e})")
            return None

    @staticmethod
    def _quarantine(path: Path, reason: str) -> None:
        """Move a bad cache entry into a `.bad/` sibling directory — kept
        for diagnosis, never silently deleted — and warn; the caller then
        rebuilds the artifact.  A quarantine that itself fails (read-only
        dir, racing quarantiners) is non-fatal: the rebuild proceeds and
        the next atomic store overwrites the bad entry in place."""
        from ..core.resilience import CacheQuarantineWarning
        dest = path.parent / ".bad" / path.name
        try:
            dest.parent.mkdir(parents=True, exist_ok=True)
            os.replace(path, dest)
            placed = f"quarantined to {dest}"
        except OSError:
            placed = "left in place (quarantine move failed)"
        warnings.warn(
            f"disk cache entry {path.name} is {reason}; {placed}, "
            "rebuilding the artifact", CacheQuarantineWarning, stacklevel=4)

    @classmethod
    def _disk_store(cls, key: str, payload: dict, cache_dir) -> None:
        from ..kernels.sptrsv_level import PackedSchedule
        path = cls._cache_path(key, cache_dir)
        # "_"-prefixed keys are process-local runtime state (staged
        # schedules, compiled fns) — never serialized; packed schedules
        # are written as host arrays wherever they lie
        payload = {k: (v.to("cpu") if isinstance(v, PackedSchedule) else v)
                   for k, v in payload.items() if not k.startswith("_")}
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            # unique tmp name per writer: concurrent builders of the same
            # key each publish a complete file via atomic os.replace, so a
            # reader can never observe a torn pickle (last writer wins)
            tmp = path.parent / (
                f"{path.name}.{os.getpid()}-{uuid.uuid4().hex[:8]}.tmp")
            try:
                with open(tmp, "wb") as f:
                    pickle.dump(payload, f)
                os.replace(tmp, path)
            except BaseException:
                tmp.unlink(missing_ok=True)
                raise
        except OSError:
            pass        # read-only cache dir: operator still works, unseeded

    # -- solving --------------------------------------------------------------
    @property
    def n(self) -> int:
        return self._L.n_rows

    @property
    def schedule(self):
        return self._sched

    @property
    def transformed(self):
        return self._ts

    def _pack_device(self):
        """Where the SpTRSV kernel's packed forms are certified for this
        operator (`Engine.pack_device`)."""
        return self._engine.pack_device(self.device)

    def _packed(self, which: str):
        """The payload's packed form of the main schedule ("packed") or of
        the preamble's ("preamble_packed") on this operator's device:
        packed on the host once, moved here once (`_payload_packed`)."""
        packed = _payload_packed(self._payload, which).to(self.device)
        self._payload[which] = packed
        return packed

    def _staged(self):
        ds = self._runtime.get("dsched")
        if ds is None:
            from .levelset import to_device
            # on a card the CUDA kernel reads the packed form the payload
            # keeps (built, loaded from disk or refreshed with new values)
            packed = self._packed("packed") if self.device.type == "cuda" \
                else None
            ds = self._runtime["dsched"] = to_device(self._sched, self.device,
                                                     packed)
        return ds

    def _compiled_fn(self, engine):
        """engine -> compiled schedule fn, cached on the shared payload;
        the engine compiles the form of the schedule it reads
        (`Engine.operator_form`: the sharded one the host schedule, so
        nothing unpadded is staged and no K1 tile is packed for it)."""
        cached = self._runtime["compiled"].get(engine.name)
        if cached is not None and cached[0] is engine:
            return cached[1]
        with _obs.span("engine.compile", engine=engine.name, n=self.n,
                       steps=self._sched.num_steps):
            fn = engine.compile(engine.operator_form(self))
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
        return _payload_preamble(self._payload)

    def _preamble_staged(self):
        """_preamble_host's schedule staged on this operator's device
        (None for an identity preamble), once."""
        if "preamble" not in self._runtime:
            from .levelset import to_device
            psched = self._preamble_host()[0]
            self._runtime["preamble"] = None if psched is None else \
                to_device(psched, self.device, self._packed(
                    "preamble_packed") if self.device.type == "cuda"
                    else None)
        return self._runtime["preamble"]

    def _preamble_maps(self):
        """The preamble's (src, row_pos) index maps on this operator's
        device, once ((None, None) for an identity preamble)."""
        entry = self._runtime.get("preamble_maps")
        if entry is None:
            _, src, row_pos = self._preamble_host()
            entry = self._runtime["preamble_maps"] = (None, None) \
                if src is None else (torch.as_tensor(src, device=self.device),
                                     torch.as_tensor(row_pos,
                                                     device=self.device))
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
        src, row_pos = self._preamble_maps()
        pre_fn = None
        if src is not None:
            cached = self._runtime["pre_compiled"].get(eng.name)
            if cached is not None and cached[0] is eng:
                pre_fn = cached[1]
            else:
                pre_fn = eng.compile(eng.operator_form(self, "preamble"))
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

    def _reference_solve(self, b: np.ndarray) -> np.ndarray:
        """Host solve of this sweep in float64 — scipy's
        `spsolve_triangular` when available, else the port's sequential
        loop (`reference.solve_csr_seq`) — built directly from the ORIGINAL
        matrix, so no bad schedule payload or failing engine can poison it.
        The escape hatch of the "fallback" and "repair" policies on a
        CPU-staged operator only (never on a card, never the serving path:
        it is host-sequential and slow); every solve it serves is warned
        and counted by the caller."""
        entry = self._runtime.get("ref_system")
        if entry is None:
            L_eff, rev = orient_lower(self._L, self.side, self.transpose)
            try:
                import scipy.sparse as sp
                mat = sp.csr_matrix(
                    (np.asarray(L_eff.data, dtype=np.float64),
                     L_eff.indices, L_eff.indptr), shape=L_eff.shape)
                entry = ("scipy", mat, rev)
            except ImportError:  # pragma: no cover - scipy ships in the env
                entry = ("seq", L_eff, rev)
            self._runtime["ref_system"] = entry
        kind, mat, rev = entry
        v = np.asarray(b, dtype=np.float64)
        if rev:
            v = v[::-1]
        if kind == "scipy":
            from scipy.sparse.linalg import spsolve_triangular
            x = spsolve_triangular(mat, v, lower=True)
        else:
            from .reference import solve_csr_seq
            x = solve_csr_seq(mat, v) if v.ndim == 1 else np.stack(
                [solve_csr_seq(mat, v[:, j]) for j in range(v.shape[1])],
                axis=1)
        return np.asarray(x[::-1] if rev else x, dtype=np.float64)

    def _remember_failure(self, engine, exc: Exception) -> str:
        """Memoize that `engine` cannot serve this payload on this device
        (it is unavailable, or its compile raised: a capability check, a
        failed build or staging of the kernels), so a hot operator does not
        retry it on every solve.  Returns the reason."""
        reason = f"{type(exc).__name__}: {exc}"
        self._runtime.setdefault("engine_failures", {})[engine.name] = reason
        return reason

    def _fallback_solve(self, v, eng, out_dtype=None):
        """`_oriented_solve` through `eng`, walking the registry's fallback
        chain (engines.engine_fallbacks, resolved for this operator's
        device) when an engine is unavailable or its compile or call
        raises.  Returns (x, engine_used).

        What `available()` and `compile()` raise is memoized on the shared
        payload, so a known-broken engine is not re-tried on every solve
        of a hot operator.  What the compiled callable raises when it is
        called is not: the next solve tries the engine again, so one
        failed launch never leaves an operator that cannot serve.  Each
        downgrade bumps `stats.fallbacks` and warns once per (requested,
        used) pair; an exhausted chain raises EngineFallbackError naming
        every attempt and its reason.
        """
        from ..core.resilience import EngineFallbackError
        from .engines import engine_fallbacks
        failures = self._runtime.setdefault("engine_failures", {})
        attempts = []
        for cand in (eng, *engine_fallbacks(eng, device=self.device)):
            known = failures.get(cand.name)
            if known is not None:
                attempts.append((cand.name, f"previously failed ({known})"))
                continue
            compiled = False
            try:
                if not cand.available():
                    raise RuntimeError("engine reports unavailable")
                with _obs.span("engine.solve", engine=cand.name):
                    self._compiled_fn(cand)
                    compiled = True
                    x = self._oriented_solve(v, cand, out_dtype=out_dtype)
            except Exception as e:  # availability, compile, or the call
                attempts.append((cand.name, self._remember_failure(cand, e)
                                 if not compiled else
                                 f"{type(e).__name__}: {e}"))
                continue
            if attempts:            # served, but not by the requested engine
                self._note_fallback(eng, cand, attempts)
            return x, cand
        raise EngineFallbackError(
            f"TriangularOperator(n={self.n}, engine={eng.name!r})", attempts)

    def _note_fallback(self, requested, used, attempts) -> None:
        # warn once per (requested, used) pair; `fallbacks` counts every
        # downgraded dispatch and `fallback_downgrades` only the first
        # sighting of a pair, matching the warning (OperatorStats doc)
        warned = self._runtime.setdefault("warned_fallbacks", set())
        pair = (requested.name, used.name)
        new_pair = pair not in warned
        self.stats.record_fallback(f"{requested.name}->{used.name}",
                                   new_pair=new_pair)
        _obs.event("engine.fallback", requested=requested.name,
                   used=used.name, new_pair=new_pair)
        if new_pair:
            warned.add(pair)
            from ..core.resilience import EngineFallbackWarning
            detail = "; ".join(f"{n}: {r}" for n, r in attempts)
            warnings.warn(
                f"engine {requested.name!r} failed, solve downgraded to "
                f"{used.name!r} [{detail}]", EngineFallbackWarning,
                stacklevel=4)

    def _health_recover(self, b, x, reason, stage, guard, eng):
        """Apply the policy's on_nonfinite action to an unhealthy solve:
        "repair" sanitizes non-finite entries and iteratively refines
        through the operator's engine chain (on a card, the CUDA kernel),
        escalating to the host reference after max_repair_rounds;
        "fallback" goes straight to the reference; anything else (or an
        unrecoverable solve) raises a typed NumericalHealthError naming
        what was attempted.  On a card there is no reference step: what
        the rounds cannot repair raises (fallbacks=["repair"])."""
        from ..core.resilience import (HealthRepairWarning,
                                       NumericalHealthError, ResilienceError)
        policy, st = guard.policy, self.stats
        st.record_health_event()
        _obs.event("health.violation", stage=stage, reason=reason)
        attempted = []
        if policy.on_nonfinite == "repair":
            attempted.append("repair")
            xr = np.where(np.isfinite(x), x, 0.0).astype(np.float64)
            for _ in range(policy.max_repair_rounds):
                r = b - self._L.matvec(xr, transpose=self.transpose)
                if not np.isfinite(r).all():
                    break
                try:
                    xr = xr + self._fallback_solve(r, eng,
                                                   out_dtype=np.float64)[0]
                except ResilienceError:
                    break       # no usable device engine: escalate
                if not np.isfinite(xr).all():
                    break       # corrections are poisoned too: escalate
                resid = self._relative_residual(b, xr)
                if resid <= policy.residual_tol:
                    st.record_health_action(f"{stage}:repaired")
                    warnings.warn(
                        f"unhealthy solve ({reason}) repaired by iterative "
                        f"refinement in {guard.where}", HealthRepairWarning,
                        stacklevel=3)
                    return xr, resid
        if policy.on_nonfinite in ("repair", "fallback") and \
                self.device.type == "cpu":
            # the host reference stands in for a CPU-staged operator only:
            # on a card the kernel serves the solve or it raises
            attempted.append("reference")
            xref = self._reference_solve(b)
            if np.isfinite(xref).all():
                resid = self._relative_residual(b, xref)
                st.record_health_action(f"{stage}:reference")
                warnings.warn(
                    f"unhealthy solve ({reason}) recovered via the host "
                    f"reference solve in {guard.where}", HealthRepairWarning,
                    stacklevel=3)
                return xref, resid
        st.record_health_action(f"{stage}:raised")
        raise NumericalHealthError(reason, stage=stage, where=guard.where,
                                   fallbacks=attempted)

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

        health: a HealthPolicy, a named level ("off" | "on" | "strict" |
        "repair" | "fallback"), or None for the REPRO_HEALTH_CHECKS
        environment default ("on").  Controls the SolveGuard around this
        solve — a non-finite b raises NumericalHealthError; an unhealthy
        solution is raised ("on", "strict"), repaired by refinement
        through the operator's engine ("repair"), or replaced by the
        float64 host reference solve ("fallback", and "repair" when
        refinement cannot reach the policy's residual_tol); the first
        solve and every refinement correction walk the engine's fallback
        chain, which on a card never holds the plain engine.  An exhausted
        chain raises EngineFallbackError, except under "repair" and
        "fallback" on a CPU-staged operator, where the host reference
        serves the solve with a HealthRepairWarning and
        stats.last_health_event == "engine:reference".  On a card the
        host reference never serves: what the kernel cannot serve or
        the refinement rounds cannot repair raises, under every policy.
        Health recoveries return float64 regardless of max_refine.
        """
        from ..core.resilience import (EngineFallbackError,
                                       HealthRepairWarning, SolveGuard,
                                       resolve_health_policy)
        from .engines import resolve_engine
        eng = self._engine if engine is None else \
            resolve_engine(engine, device=self.device)
        if self.device.type not in getattr(eng, "device_types",
                                           (self.device.type,)):
            # the caller's mistake, not an engine failure: no chain
            raise ValueError(f"engine {eng.name!r} runs on "
                             f"{tuple(eng.device_types)}, not on "
                             f"{self.device}")
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
        served_by_reference = False
        columns = 1 if b.ndim == 1 else b.shape[1]
        with _obs.span("operator.solve", n=self.n, engine=eng.name,
                       columns=columns) as sp:
            try:
                x, eng = self._fallback_solve(
                    b, eng, out_dtype=np.float64 if max_refine > 0 else None)
            except EngineFallbackError:
                # no engine of the chain served; only a recovering policy
                # on a CPU-staged operator may serve the solve from the
                # host reference, and never silently.  On a card it raises
                if policy.on_nonfinite == "raise" or \
                        self.device.type != "cpu":
                    raise
                self.stats.record_health_event("engine:reference")
                warnings.warn(
                    "every engine in the fallback chain failed; solve served "
                    f"by the host reference in {guard.where}",
                    HealthRepairWarning, stacklevel=2)
                x = self._reference_solve(b)
                served_by_reference = True
            if served_by_reference:
                resid = self._relative_residual(b, x)
            elif max_refine > 0:    # refinement off => skip the host matvec
                bscale = max(1.0, float(np.abs(b).max(initial=0.0)))
                with _obs.span("operator.refine", tol=refine_tol) as rsp:
                    while True:
                        r = b - self._L.matvec(x, transpose=self.transpose)
                        resid = float(np.abs(r).max(initial=0.0)) / bscale
                        if not np.isfinite(resid):
                            break   # poisoned pipeline: corrections would
                                    # be NaN too — the health action below
                                    # decides
                        if resid <= refine_tol or rounds >= max_refine:
                            break
                        x = x + self._fallback_solve(
                            r, eng, out_dtype=np.float64)[0]
                        rounds += 1
                    rsp.set(rounds=rounds, residual=resid)
            if not served_by_reference:
                reason, stage = guard.output_unhealthy(x), "output"
                if reason is None and policy.residual_check:
                    if not np.isfinite(resid):  # nan: unset (max_refine=0)
                        resid = self._relative_residual(b, x)   # or poisoned
                    reason, stage = guard.residual_unhealthy(resid), \
                        "residual"
                if reason is not None:
                    x, resid = self._health_recover(b, x, reason, stage,
                                                    guard, eng)
            ms = (time.perf_counter() - t0) * 1e3
            sp.set(ms=ms, rounds=rounds, engine_used=eng.name,
                   reference=served_by_reference)
            self.stats.record_solve(ms=ms, columns=columns, rounds=rounds,
                                    residual=resid)
        return x

    def __repr__(self) -> str:  # pragma: no cover
        return (f"TriangularOperator(n={self.n}, side={self.side!r}, "
                f"transpose={self.transpose}, strategy={self.strategy!r}, "
                f"steps={self._sched.num_steps}, engine={self.engine!r}, "
                f"device={self.device}, cache={self.stats.cache_source})")
