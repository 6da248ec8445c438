"""Warm-cache admission tier: cold operators serve NOW, tuning runs behind.

Port of `repro.serving.registry`, over the port's `TriangularOperator`
(`from_csr_kwargs` carry `device=`: the card unless the caller passes
"cpu").  The registry owns one `OperatorEntry` per admitted (pattern, dtype,
orientation) and enforces the serving tier's core latency contract:

* **cold** admission NEVER waits for the auto-tuner.  A first-seen matrix
  is built synchronously with `tune="no_rewriting"` — plain level
  scheduling, no strategy search — which is the cheap part of a build
  (the portfolio sweep is what costs ~10x), so the first request's
  response time is bounded by one untuned compile + solve.
* the entry enters **warming**: a background worker runs the full
  `StrategyPortfolio` search (`tune="auto"`) OFF the request path,
  through the same `TriangularOperator.from_csr` disk/memory cache every
  offline build uses (a previously tuned pattern hot-swaps instantly).
* when tuning lands, the tuned operator is **hot-swapped** atomically
  under the entry lock: requests in flight finish on the operator they
  started with, the next dispatch sees the tuned one, and if the entry's
  values drifted while tuning ran (update_values traffic), the tuned
  operator is re-bound to the LATEST values before it is published —
  a swap can never resurrect stale numerics.  On the card that re-bind
  is a device refresh of the SpTRSV kernel's packed tiles (a re-pack when
  the float32 zero set moved), enqueued on the stream before the swap is
  published, so every later solve reads the refreshed tiles.  The entry
  is now **hot**.
* a tuner failure (any exception out of the background build, or out of
  the re-bind of the tuned operator to the entry's latest values before
  the swap, e.g. a replay whose fill leaves the frozen pattern) marks the
  entry **degraded**: the untuned operator keeps serving, a
  `TunerFailureWarning` is emitted, the registry counts a tuner failure,
  and the error is retained on the entry for the stats plane.  Tuning
  never poisons the request path.  (The reference lets a failed re-bind
  escape the tune job and leaves the entry "warming".)

Value-only refreshes (same pattern, new numeric payload — the
time-stepping workload) do not re-admit: `entry.note_values`
registers the new payload and `entry.ensure_values` re-binds the live
operator through `update_values` at batch-dispatch time, under the same
entry lock that serializes solves, updates, and swaps for that entry.
"""
from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import threading
import time
import warnings

import numpy as np

from ..core.resilience import TunerFailureWarning
from ..obs import trace as _obs
from ..obs.metrics import MetricsRegistry
from ..solver.operator import (TriangularOperator, matrix_fingerprint,
                               value_fingerprint)
from .batcher import BatchKey

__all__ = ["EntryKey", "OperatorEntry", "OperatorRegistry"]

# newest value payloads retained per entry, so in-flight batches keyed by
# an older value fingerprint can still re-bind and solve correctly while
# newer updates stream in
_VALUE_MEMO = 8


@dataclasses.dataclass(frozen=True)
class EntryKey:
    """One admitted operator: pattern + dtype + sweep orientation.

    Value fingerprints are deliberately absent — value refreshes re-bind
    the SAME entry (that is the whole point of the update_values path).
    """

    pattern_fp: str
    dtype: str = "float32"
    side: str = "lower"
    transpose: bool = False


class OperatorEntry:
    """The registry's unit of ownership: one live operator + its lifecycle.

    `lock` serializes everything that touches the operator binding for
    this key — batched solves, value re-binding, and the tuned hot-swap —
    because `update_values` mutates the operator in place and a solve
    must never observe a half-rebound payload.  Distinct entries never
    contend: the lock is per-key, so hot traffic on one matrix cannot
    stall admissions or solves on another.
    """

    def __init__(self, ekey: EntryKey):
        self.ekey = ekey
        self.lock = threading.RLock()
        self.op: TriangularOperator | None = None
        self.state = "cold"          # cold | warming | hot | degraded
        self.bound_fp = ""           # value fingerprint the op is bound to
        self.latest_fp = ""          # newest value fingerprint ever seen
        self.hot_swaps = 0
        self.untuned_solves = 0      # solves served before the swap landed
        self.value_rebinds = 0       # dispatch-time update_values re-binds
                                     # (survives the swap, unlike op.stats)
        self.tune_error = ""
        self.admitted_at = 0.0
        self._values: "collections.OrderedDict[str, object]" = \
            collections.OrderedDict()   # value_fp -> CSR

    # -- value payloads -------------------------------------------------------
    def note_values(self, L, value_fp: str) -> None:
        """Register a numeric payload under its fingerprint (bounded memo;
        newest payloads win) and mark it the entry's latest."""
        with self.lock:
            self._values[value_fp] = L
            self._values.move_to_end(value_fp)
            while len(self._values) > _VALUE_MEMO:
                self._values.popitem(last=False)
            self.latest_fp = value_fp

    def ensure_values(self, value_fp: str):
        """Re-bind the live operator to `value_fp`'s payload (no-op when
        already bound).  Called under dispatch, immediately before the
        batched solve, holding `lock` — so every request in a batch keyed
        by `value_fp` solves exactly those values.  Returns the operator.
        """
        with self.lock:
            if self.op is None:
                raise RuntimeError(
                    f"entry {self.ekey} has no operator (not admitted?)")
            if value_fp != self.bound_fp:
                L = self._values.get(value_fp)
                if L is None:
                    raise KeyError(
                        f"value payload {value_fp!r} expired from entry "
                        f"{self.ekey} (memo keeps {_VALUE_MEMO})")
                self.op.update_values(L)
                self.bound_fp = value_fp
                self.value_rebinds += 1
            return self.op

    def batch_key(self, value_fp: str) -> BatchKey:
        return BatchKey(pattern_fp=self.ekey.pattern_fp, value_fp=value_fp,
                        dtype=self.ekey.dtype, side=self.ekey.side,
                        transpose=self.ekey.transpose)

    # -- introspection --------------------------------------------------------
    def snapshot(self) -> dict:
        with self.lock:
            op_stats = self.op.stats.to_dict() if self.op is not None else {}
            return {"state": self.state, "hot_swaps": self.hot_swaps,
                    "untuned_solves": self.untuned_solves,
                    "value_rebinds": self.value_rebinds,
                    "tune_error": self.tune_error,
                    "bound_fp": self.bound_fp, "latest_fp": self.latest_fp,
                    "strategy": getattr(self.op, "strategy", None),
                    "op": op_stats}


class OperatorRegistry:
    """Get-or-admit operators; run the portfolio tuner off the request path.

    tune_mode: "background" — admit untuned, tune on a worker thread and
                   hot-swap when done (the serving default);
               "sync"       — tune inline during admit (entries are hot
                   immediately; offline/batch jobs and deterministic tests);
               "off"        — never tune (entries stay cold; isolates the
                   batching tier in tests and benchmarks).
    untuned:   strategy for the admission build ("no_rewriting": plain
               level scheduling, no search).
    tune:      strategy spec for the background build ("auto" runs the
               full StrategyPortfolio).
    max_entries: bound on live entries; admission past the bound evicts
               the least-recently-admitted idle entry (its disk-cache
               artifact survives, so re-admission is cheap).
    clock:     injected time source for `admitted_at` stamps (defaults to
               `time.perf_counter`; tests pass a synthetic clock).
    from_csr_kwargs: forwarded to every `TriangularOperator.from_csr`
               (device=, cache=, cache_dir=, chunk=, engine=, ...);
               sharded operators (`mesh=`, engine="sharded") are refused
               with ValueError.
    """

    def __init__(self, *, tune="auto", untuned="no_rewriting",
                 tune_mode: str = "background", max_entries: int | None = None,
                 clock=time.perf_counter, **from_csr_kwargs):
        if tune_mode not in ("background", "sync", "off"):
            raise ValueError(
                f"tune_mode must be background|sync|off, got {tune_mode!r}")
        from ..solver.engines import ShardedEngine
        eng = from_csr_kwargs.get("engine")
        if "mesh" in from_csr_kwargs or "mesh_axis" in from_csr_kwargs or \
                eng == "sharded" or isinstance(eng, ShardedEngine):
            # every rank of a mesh must take the same decisions in the same
            # order; a background tuner and a worker pool per rank do not
            raise ValueError("the solve service does not serve sharded "
                             "operators (mesh=, engine='sharded'); build "
                             "them with TriangularOperator.from_csr")
        self._clock = clock
        self._tune = tune
        self._untuned = untuned
        self.tune_mode = tune_mode
        self.max_entries = max_entries
        self._kwargs = dict(from_csr_kwargs)
        self._lock = threading.RLock()
        self._entries: "collections.OrderedDict[EntryKey, OperatorEntry]" = \
            collections.OrderedDict()
        self._tuner: concurrent.futures.ThreadPoolExecutor | None = None
        self._tune_jobs: dict = {}        # EntryKey -> Future
        self._closed = False
        # registry-wide lifecycle counters live in a metrics registry so
        # stats() and the Prometheus page read the same ledger; the
        # hot_swaps/value_rebinds/states aggregates stay entry-derived at
        # read time (no dual bookkeeping)
        self.metrics = MetricsRegistry(prefix="repro_registry")
        self._admissions = self.metrics.counter(
            "admissions", "first-seen patterns admitted")
        self._evictions = self.metrics.counter(
            "evictions", "idle entries evicted over max_entries")
        self._tuner_failures = self.metrics.counter(
            "tuner_failures", "background tunes that raised (degraded)")

    @property
    def admissions(self) -> int:
        return self._admissions.value()

    @property
    def evictions(self) -> int:
        return self._evictions.value()

    @property
    def tuner_failures(self) -> int:
        return self._tuner_failures.value()

    # -- admission ------------------------------------------------------------
    def admit(self, L, *, dtype="float32", side: str = "lower",
              transpose: bool = False):
        """Get-or-create the entry for L's pattern; returns
        (entry, batch_key, created) with the batch key pinned to L's
        CURRENT value fingerprint.  First admission (created=True) builds
        the untuned operator synchronously (bounded latency) and, in
        background mode, schedules the portfolio tune; re-admission with
        new values registers the payload for dispatch-time re-binding and
        touches nothing else.
        """
        dtype = np.dtype(dtype).name
        with _obs.span("registry.admit", dtype=dtype) as asp:
            ekey = EntryKey(
                pattern_fp=matrix_fingerprint(L, include_values=False),
                dtype=dtype, side=side, transpose=bool(transpose))
            value_fp = value_fingerprint(L)
            with self._lock:
                if self._closed:
                    raise RuntimeError("registry is closed")
                entry = self._entries.get(ekey)
                created = entry is None
                if created:
                    entry = self._entries[ekey] = OperatorEntry(ekey)
                    self._admissions.inc()
                    # hold the entry lock BEFORE it escapes the registry
                    # lock: concurrent admitters / dispatchers block on
                    # entry.lock until the untuned operator exists, instead
                    # of observing a published-but-empty entry
                    entry.lock.acquire()
                self._entries.move_to_end(ekey)
            asp.set(created=created, pattern=ekey.pattern_fp[:8])
            if created:
                try:
                    entry.note_values(L, value_fp)
                    entry.admitted_at = self._clock()
                    if self.tune_mode == "sync":
                        entry.op = self._build(L, self._tune, ekey)
                        entry.state = "hot"
                    else:
                        entry.op = self._build(L, self._untuned, ekey)
                        if self.tune_mode == "background":
                            entry.state = "warming"
                            self._schedule_tune(entry, L)
                        # "off": stays cold — batching-tier isolation
                    entry.bound_fp = value_fp
                finally:
                    entry.lock.release()
                self._evict_over_cap()
            else:
                entry.note_values(L, value_fp)
            return entry, entry.batch_key(value_fp), created

    def _build(self, L, tune, ekey: EntryKey) -> TriangularOperator:
        return TriangularOperator.from_csr(
            L, tune=tune, side=ekey.side, transpose=ekey.transpose,
            dtype=np.dtype(ekey.dtype), **self._kwargs)

    # -- background tuning ----------------------------------------------------
    def _schedule_tune(self, entry: OperatorEntry, L) -> None:
        with self._lock:
            if self._tuner is None:
                self._tuner = concurrent.futures.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="repro-tuner")
            self._tune_jobs[entry.ekey] = self._tuner.submit(
                self._tune_and_swap, entry, L)

    def _tune_and_swap(self, entry: OperatorEntry, L) -> None:
        pat = entry.ekey.pattern_fp[:8]
        with _obs.span("registry.tune", pattern=pat) as tsp:
            try:
                # the slow part runs UNLOCKED: requests keep flowing
                # through the untuned operator while the portfolio searches
                tuned = self._build(L, self._tune, entry.ekey)
            except Exception as exc:     # noqa: BLE001 - any tuner blow-up
                self._tune_failed(entry, exc, tsp, pat)
                return
            with entry.lock:
                try:
                    if entry.bound_fp and \
                            entry.bound_fp != value_fingerprint(tuned._L):
                        # values drifted while tuning ran: re-bind the tuned
                        # operator to the entry's CURRENT payload before it
                        # is visible to anyone — the swap must not roll
                        # numerics back
                        tuned.update_values(entry._values[entry.bound_fp])
                        entry.value_rebinds += 1
                except Exception as exc:  # noqa: BLE001 - a re-bind the
                    # tuned transformation cannot follow: not swapped
                    self._tune_failed(entry, exc, tsp, pat)
                    return
                entry.untuned_solves = entry.op.stats.solves \
                    if entry.op is not None else 0
                entry.op = tuned
                entry.state = "hot"
                entry.hot_swaps += 1
            tsp.set(outcome="hot_swap")
            _obs.event("registry.hot_swap", pattern=pat,
                       strategy=getattr(tuned, "strategy", None))

    def _tune_failed(self, entry: OperatorEntry, exc: Exception, tsp,
                     pat: str) -> None:
        """A tune, or the re-bind of its operator to the entry's current
        values, raised: the entry is degraded and keeps serving its
        untuned operator."""
        with entry.lock:
            entry.state = "degraded"
            entry.tune_error = f"{type(exc).__name__}: {exc}"
        self._tuner_failures.inc()
        tsp.set(outcome="degraded")
        _obs.event("registry.tune_failed", pattern=pat,
                   error=type(exc).__name__)
        warnings.warn(
            f"background tuning failed for {pat}; serving continues on "
            f"the untuned operator ({exc})", TunerFailureWarning,
            stacklevel=3)

    def wait_warm(self, timeout: float | None = None) -> bool:
        """Block until every scheduled tune has finished (swapped or
        degraded).  Returns False on timeout.  Test/benchmark hook — the
        serving path never calls this."""
        with self._lock:
            jobs = list(self._tune_jobs.values())
        done, not_done = concurrent.futures.wait(jobs, timeout=timeout)
        return not not_done

    # -- capacity -------------------------------------------------------------
    def _evict_over_cap(self) -> None:
        if self.max_entries is None:
            return
        with self._lock:
            while len(self._entries) > self.max_entries:
                victim_key = next(iter(self._entries))   # oldest admission
                job = self._tune_jobs.get(victim_key)
                if job is not None and not job.done():
                    break   # never evict mid-tune; retry on next admission
                del self._entries[victim_key]
                self._tune_jobs.pop(victim_key, None)
                self._evictions.inc()

    # -- lookup / stats -------------------------------------------------------
    def get(self, ekey: EntryKey) -> OperatorEntry | None:
        with self._lock:
            return self._entries.get(ekey)

    def entries(self) -> list:
        """Live (EntryKey, OperatorEntry) pairs (scrape/introspection)."""
        with self._lock:
            return list(self._entries.items())

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            entries = dict(self._entries)
            counters = {"admissions": self.admissions,
                        "evictions": self.evictions,
                        "tuner_failures": self.tuner_failures}
        snaps = {f"{k.pattern_fp[:8]}:{k.dtype}:{k.side}"
                 f"{':T' if k.transpose else ''}": e.snapshot()
                 for k, e in entries.items()}
        counters["hot_swaps"] = sum(s["hot_swaps"] for s in snaps.values())
        counters["value_rebinds"] = sum(s["value_rebinds"]
                                        for s in snaps.values())
        counters["states"] = collections.Counter(
            s["state"] for s in snaps.values())
        counters["entries"] = snaps
        return counters

    # -- lifecycle ------------------------------------------------------------
    def close(self, wait: bool = True) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            tuner = self._tuner
        if tuner is not None:
            tuner.shutdown(wait=wait, cancel_futures=not wait)
