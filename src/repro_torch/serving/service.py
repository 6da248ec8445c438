"""SolveService: the multi-tenant front door over batcher + registry.

Port of `repro.serving.service`.  One object owns the whole request path:

    with SolveService(max_width=16, max_linger_s=0.002) as svc:   # card
        fut = svc.submit(b, matrix=L, tenant="alice")   # future
        x = fut.result()
        x = svc.solve(b2, matrix=L)                     # sync sugar
    SolveService(device="cpu", ...)                     # the host path

`device=` (with every other registry keyword) reaches
`TriangularOperator.from_csr`; a batch of one column runs the SpTRSV
kernel's single-column form (K1), a wider one its multi-column form (K2).
A batch whose solve raises resolves every one of its futures with that
exception: nothing is served by another engine or on the host.

`submit` admits the matrix through the `OperatorRegistry` (cold builds
are synchronous but untuned; tuning runs behind — see registry.py),
enforces the per-tenant in-flight cap (a typed
`repro_torch.core.resilience.AdmissionError` on overflow; one tenant's burst
cannot exhaust another's headroom), and enqueues into the
`MicroBatcher`.  Batches flush by width (inline, on the submitting
thread's notification) or by linger deadline (the dispatcher thread
sleeps until `next_deadline()`), and execute on a small worker pool:
under the owning entry's lock, the batch's value fingerprint is
re-bound via `ensure_values`, the stacked (n, k) right-hand side is
solved once, and each column resolves its request's future.

Determinism for tests: construct with `auto_dispatch=False` and no
thread is spawned — width-full batches queue instead of dispatching,
and `pump()` drains everything synchronously on the calling thread, so
batching behavior is exactly reproducible.

Under a mesh (`mesh=`, or engine="sharded"; every rank constructs the
service with the same arguments, at the same point: the construction
agrees on a command channel) the axis' first rank owns the front door:
`submit`, the tenant caps, the batcher, admission and eviction, the
value fingerprints.  It serves through ONE mesh thread (in pump mode,
the calling thread) that broadcasts each command to the other ranks and
then runs it: admit a pattern (its CSR), evict, solve a batch (its
stacked, padded B, and the CSR of a value re-bind), run a deferred tune
and its hot swap, close.  The other ranks call `follow()`, which runs
rank 0's commands in rank 0's order until rank 0 closes, so every
collective on every rank is issued from one thread in one order.  A
follower waits for the next command on the process group's store (a
key per command, polled), never inside a collective, so a service may
sit idle past the group's collective timeout.  Batches run one at a
time, in dispatch order; a background tune runs between them.  Every
rank agrees on each step of a command that can fail on one rank alone
(`distributed.settle`): an admission, a batch's re-bind and its solve,
a tune's build and its re-bind.  What failed on any rank fails on every
rank as the same `ShardedCallError` before the next collective: a batch's
futures carry it and the next batch is served, a failed admission is
undone on every rank, a failed tune swaps on no rank.  Without a mesh
nothing of this applies: two workers and a background tuner thread, as
before.

`ServiceStats` is the observability plane: request/batch counters, the
batch-width histogram (is coalescing actually happening?), cache-hit
sources (registry vs the operator cache's built/memory/disk/pattern),
and separate queue-vs-solve latency reservoirs with percentiles — plus
the registry's lifecycle counters (states, hot swaps, tuner failures)
merged into every snapshot.
"""
from __future__ import annotations

import collections
import concurrent.futures
import threading
import time
import uuid

import numpy as np

from ..core.resilience import AdmissionError
from ..obs import trace as _obs
from ..obs.metrics import MetricsRegistry, nearest_rank_percentile
from ..solver.operator import matrix_fingerprint, value_fingerprint
from .batcher import Batch, MicroBatcher, SolveRequest
from .registry import EntryKey, OperatorRegistry, serving_mesh

__all__ = ["SolveService", "ServiceStats"]

_RESERVOIR = 100_000     # latency samples retained per series
# a follower's poll of the store for rank 0's next command: its first and
# its longest pause (s); the pause doubles while the service is idle
_POLL_S = (1e-4, 5e-3)


def _percentile(samples, q: float) -> float:
    """Nearest-rank percentile of a list (NaN when empty) — the one
    formula, owned by repro_torch.obs.metrics."""
    return nearest_rank_percentile(samples, q)


def _store():
    """The default process group's store: where rank 0 posts each
    command's key for the followers (module doc)."""
    import torch.distributed as dist
    return dist.distributed_c10d._get_default_store()


def _entry_key(key) -> EntryKey:
    """The registry's key of a batch key's entry."""
    return EntryKey(pattern_fp=key.pattern_fp, dtype=key.dtype,
                    side=key.side, transpose=key.transpose)


class ServiceStats:
    """The service's stats plane: a VIEW over a `repro_torch.obs` metrics
    registry (prefix "repro_service") — counters, labeled counters for
    the width/flush/source breakdowns, and two latency histograms whose
    bounded reservoirs feed the nearest-rank percentiles.  `snapshot()`
    and the Prometheus exporter read the SAME instruments; there is no
    second ledger.  Multi-instrument events
    commit atomically under the registry's one shared lock."""

    def __init__(self, registry: MetricsRegistry | None = None):
        self.registry = registry if registry is not None \
            else MetricsRegistry(prefix="repro_service")
        r = self.registry
        self._lock = r.lock
        self._submitted = r.counter("submitted", "requests admitted")
        self._completed = r.counter("completed",
                                    "requests resolved with a solution")
        self._rejected = r.counter("rejected",
                                   "requests rejected by the tenant cap")
        self._failed = r.counter("failed",
                                 "requests resolved with an exception")
        self._batches = r.counter("batches", "batches executed")
        self._batch_errors = r.counter("batch_errors", "batches that raised")
        self._width_hist = r.counter("batch_width", "batches by width")
        self._flush_reasons = r.counter(
            "batch_flush", "batches by flush reason (width|linger|drain)")
        self._cache_sources = r.counter(
            "cache_source", "admissions by operator cache source")
        self._rejected_by_tenant = r.counter("rejected_tenant",
                                             "rejections per tenant")
        self._queue_ms = r.histogram(
            "queue_ms", "enqueue->dispatch wait per request (ms)",
            reservoir=_RESERVOIR)
        self._solve_ms = r.histogram(
            "solve_ms", "dispatch->solved per batch (ms)",
            reservoir=_RESERVOIR)

    # -- attribute views (the pre-registry public surface) --------------------
    @property
    def submitted(self) -> int:
        return self._submitted.value()

    @property
    def completed(self) -> int:
        return self._completed.value()

    @property
    def rejected(self) -> int:
        return self._rejected.value()

    @property
    def failed(self) -> int:
        return self._failed.value()

    @property
    def batches(self) -> int:
        return self._batches.value()

    @property
    def batch_errors(self) -> int:
        return self._batch_errors.value()

    @staticmethod
    def _labeled(counter, label, cast=lambda v: v):
        return collections.Counter(
            {cast(dict(k)[label]): v for k, v in counter.series().items()})

    @property
    def width_hist(self):               # batch width -> count
        return self._labeled(self._width_hist, "width", int)

    @property
    def flush_reasons(self):            # width | linger | drain
        return self._labeled(self._flush_reasons, "reason")

    @property
    def cache_sources(self):            # registry|built|memory|...
        return self._labeled(self._cache_sources, "source")

    @property
    def rejected_by_tenant(self):
        return self._labeled(self._rejected_by_tenant, "tenant")

    @property
    def queue_ms(self) -> list:         # enqueue -> dispatch, per request
        return self._queue_ms.samples()

    @property
    def solve_ms(self) -> list:         # dispatch -> solved, per batch
        return self._solve_ms.samples()

    # -- recording ------------------------------------------------------------
    def record_submit(self, source: str) -> None:
        with self._lock:
            self._submitted.inc()
            self._cache_sources.inc(source=source)

    def record_reject(self, tenant: str) -> None:
        with self._lock:
            self._rejected.inc()
            self._rejected_by_tenant.inc(tenant=tenant)

    def record_batch(self, batch, queue_ms, solve_ms: float) -> None:
        with self._lock:
            self._batches.inc()
            self._completed.inc(batch.width)
            self._width_hist.inc(width=int(batch.width))
            self._flush_reasons.inc(reason=batch.reason)
            for v in queue_ms:
                self._queue_ms.observe(v)
            self._solve_ms.observe(solve_ms)

    def record_batch_error(self, batch) -> None:
        with self._lock:
            self._batches.inc()
            self._batch_errors.inc()
            self._failed.inc(batch.width)
            self._width_hist.inc(width=int(batch.width))
            self._flush_reasons.inc(reason=batch.reason)

    # -- reading --------------------------------------------------------------
    def mean_width(self) -> float:
        with self._lock:
            hist = self.width_hist
            n = sum(hist.values())
            return (sum(w * c for w, c in hist.items()) / n
                    if n else float("nan"))

    def snapshot(self, registry: OperatorRegistry | None = None) -> dict:
        with self._lock:
            snap = {
                "submitted": self.submitted, "completed": self.completed,
                "rejected": self.rejected, "failed": self.failed,
                "batches": self.batches, "batch_errors": self.batch_errors,
                "width_hist": dict(sorted(self.width_hist.items())),
                "flush_reasons": dict(self.flush_reasons),
                "cache_sources": dict(self.cache_sources),
                "rejected_by_tenant": dict(self.rejected_by_tenant),
                "queue_ms": {"p50": self._queue_ms.percentile(50),
                             "p99": self._queue_ms.percentile(99)},
                "solve_ms": {"p50": self._solve_ms.percentile(50),
                             "p99": self._solve_ms.percentile(99)},
            }
        n = sum(snap["width_hist"].values())
        snap["mean_width"] = (sum(w * c for w, c in snap["width_hist"]
                                  .items()) / n) if n else float("nan")
        if registry is not None:
            reg = registry.stats()
            reg.pop("entries", None)    # per-entry detail stays opt-in
            snap["registry"] = reg
        return snap


class SolveService:
    """Multi-tenant micro-batching solve service (see module doc).

    max_width / max_linger_s: the batcher's flush policy.
    tenant_cap:   per-tenant in-flight request bound (None = unlimited);
                  exceeding it raises AdmissionError instead of queueing.
    workers:      batched-solve worker threads (distinct keys solve
                  concurrently; one key's batches serialize on its entry
                  lock regardless, so more workers than hot keys is waste).
    auto_dispatch: False spawns NO threads — batches accumulate until
                  `pump()` runs them on the calling thread (deterministic
                  tests); width/linger policy is otherwise identical.
    pad_widths:   pad every multi-column batch to the next power-of-two
                  width with zero columns before solving (default True),
                  as the reference does.  On the card it caps the
                  column counts K2 runs at log2(max_width) + 1 and puts
                  every batch of 3 or more columns at a multiple of four,
                  where K2 gathers four columns per load (float4).
                  Zero columns solve to zero and are sliced off before
                  futures resolve.
    solve_kwargs: forwarded to every TriangularOperator.solve; the default
                  {"max_refine": 0} is the raw float32 device path —
                  serving wants throughput, callers wanting refined
                  float64 pass {"max_refine": 6} etc.
    registry:     a pre-configured OperatorRegistry; default builds one
                  from **registry_kwargs (tune_mode=, cache=, mesh=, ...).
                  Under a mesh (module doc) rank 0 serves and every other
                  rank calls `follow()`; `workers` is then 1, and a
                  follower's registry evicts only on rank 0's command
                  (its `max_entries` is set to None).
    """

    def __init__(self, *, max_width: int = 16, max_linger_s: float = 0.002,
                 tenant_cap: int | None = 64, workers: int = 2,
                 auto_dispatch: bool = True, pad_widths: bool = True,
                 solve_kwargs: dict | None = None,
                 registry: OperatorRegistry | None = None,
                 **registry_kwargs):
        # a caller-supplied registry is shared state (e.g. one tuned
        # registry reused across benchmark sweeps): the service never
        # closes it
        self._own_registry = registry is None
        # (mesh, axis) whose ranks serve together, this rank's index, size
        self.mesh = registry.mesh if registry is not None \
            else serving_mesh(registry_kwargs)
        self.rank, self.mesh_size = 0, 1
        self._channel = ""       # the mesh's command channel (its keys)
        if self.mesh is not None:
            from ..solver.distributed import agree, axis_group
            _, self.mesh_size, self.rank = axis_group(*self.mesh)
            self._channel = agree(uuid.uuid4().hex, *self.mesh)
        self.registry = registry if registry is not None \
            else OperatorRegistry(**registry_kwargs)
        if self.rank != 0:
            # a follower's entries mirror rank 0's: rank 0 alone evicts,
            # by its own LRU order, and sends each eviction
            self.registry.max_entries = None
        self._commands = 0       # mesh commands sent (rank 0) or run
        # the newest commands, (kind, pattern[:8]) in this rank's order
        self.mesh_log: collections.deque = collections.deque(maxlen=1024)
        self._queued = 0         # batches handed to the pool, not started
        self._follow_errors = collections.Counter()  # kind -> failed
        self._last_follow_error = ""
        self.tenant_cap = tenant_cap
        self.solve_kwargs = {"max_refine": 0} if solve_kwargs is None \
            else dict(solve_kwargs)
        self.stats = ServiceStats()
        self.pad_widths = bool(pad_widths)
        self._clock = time.perf_counter
        self._batcher = MicroBatcher(max_width=max_width,
                                     max_linger_s=max_linger_s)
        self._cond = threading.Condition()
        self._pending: list = []          # batches awaiting pump/dispatch
        self._inflight = collections.Counter()      # tenant -> open requests
        self._tenant_lock = threading.Lock()
        self._closed = False
        # a follower runs rank 0's commands in follow(): no thread of its own
        self._auto = bool(auto_dispatch) and self.rank == 0
        # under a mesh ONE worker: the mesh thread, whose FIFO is the order
        # every rank issues its collectives in
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1 if self.mesh is not None else max(1, workers),
            thread_name_prefix="repro-solve") if self._auto else None
        self._dispatcher = None
        if self._auto:
            self._dispatcher = threading.Thread(
                target=self._dispatch_loop, name="repro-dispatch",
                daemon=True)
            self._dispatcher.start()

    # -- request path ---------------------------------------------------------
    def submit(self, b, matrix, *, tenant: str = "default",
               dtype: str = "float32", side: str = "lower",
               transpose: bool = False) -> concurrent.futures.Future:
        """Admit `matrix` (cold patterns build untuned, synchronously) and
        enqueue one solve of `b` against it.  Returns a Future resolving
        to the solution column; raises AdmissionError when `tenant`
        already has `tenant_cap` requests in flight."""
        if self._closed:
            raise RuntimeError("service is closed")
        if self.rank != 0:
            raise RuntimeError(
                f"rank {self.rank} follows the mesh's rank 0, which alone "
                f"takes requests: call follow() here, submit on rank 0")
        with _obs.span("serving.submit", tenant=tenant) as ssp:
            with self._tenant_lock:
                depth = self._inflight[tenant]
                if self.tenant_cap is not None and depth >= self.tenant_cap:
                    self.stats.record_reject(tenant)
                    raise AdmissionError("tenant queue depth cap reached",
                                         tenant=tenant, depth=depth,
                                         limit=self.tenant_cap)
                self._inflight[tenant] += 1
            try:
                entry, bkey, created = self._admit(
                    matrix, dtype=dtype, side=side, transpose=transpose)
            except BaseException:
                self._release(tenant)
                raise
            b = np.asarray(b)
            if b.ndim != 1 or b.shape[0] != matrix.n_rows:
                # reject HERE: a wrong-shape column must fail its own
                # request, never reach stack() and poison a shared batch
                self._release(tenant)
                raise ValueError(
                    f"b must be ({matrix.n_rows},), got {b.shape}")
            # cold admissions surface the operator cache's source (built /
            # memory / disk / pattern); warm ones hit the live registry
            source = entry.op.stats.cache_source if created else "registry"
            self.stats.record_submit(source)
            ssp.set(source=source, created=created,
                    pattern=bkey.pattern_fp[:8])
            fut = concurrent.futures.Future()
            fut.add_done_callback(lambda _f, t=tenant: self._release(t))
            req = SolveRequest(key=bkey, b=b, tenant=tenant, future=fut)
            with self._cond:
                if self._closed:  # closed between the early check and here:
                    fut.cancel()  # cancellation releases the tenant slot
                    raise RuntimeError("service is closed")
                batch = self._batcher.enqueue(req, self._clock())
                if batch is not None and not self._auto:
                    self._pending.append(batch)
                self._cond.notify()
            if batch is not None and self._auto:
                self._dispatch(batch)
            if created and self.mesh is not None and self._auto and \
                    self.registry.pending_tunes():
                # queued once the request is: the tune yields to it
                self._pool.submit(self._tune_later)
            return fut

    def _admit(self, L, **kw) -> tuple:
        """registry.admit; under a mesh a new pattern's build runs as a
        command on the mesh thread (the caller waits for it, as a cold
        admission always does), and rank 0's evictions follow it."""
        if self.mesh is None:
            return self.registry.admit(L, **kw)
        fps = (matrix_fingerprint(L, include_values=False),
               value_fingerprint(L))
        got = self.registry.admit(L, fingerprints=fps, build=False, **kw)
        if got is not None:
            return got              # a known pattern: no build, no command

        def job():
            got = self.registry.admit(L, fingerprints=fps, build=False,
                                      **kw)
            if got is not None:
                return got          # admitted while this job waited
            before = set(k for k, _ in self.registry.entries())
            self._send(("admit", L, kw, fps))
            got = self._admitted(L, kw, fps)
            gone = before - set(k for k, _ in self.registry.entries())
            if gone:
                self._send(("evict", sorted(gone, key=repr)))
            return got

        return self._on_mesh_thread(job)

    def _admitted(self, L, kw: dict, fps: tuple):
        """An admit command's part on every rank: the build, agreed.  An
        admission that failed on any rank is undone on every rank, so
        their entries stay alike and the next request builds anew."""
        from ..solver.distributed import settle
        try:
            return settle(lambda: self.registry.admit(
                L, fingerprints=fps, **kw), "its admission", *self.mesh)
        except Exception:
            self.registry.evict(EntryKey(
                pattern_fp=fps[0], dtype=np.dtype(kw["dtype"]).name,
                side=kw["side"], transpose=bool(kw["transpose"])))
            raise

    def _on_mesh_thread(self, fn):
        """Run `fn` on the mesh thread and wait for it (in pump mode, on the
        calling thread)."""
        if not self._auto:
            return fn()
        return self._pool.submit(fn).result()

    def _send(self, cmd) -> None:
        """Broadcast one command to the mesh's other ranks (rank 0 only;
        nothing at one rank): its key on the store for each follower,
        then the command itself."""
        from ..solver.distributed import agree
        if self.mesh_size > 1:
            store = _store()
            for r in range(1, self.mesh_size):
                store.set(self._key(r), b"1")
        self._log(cmd)
        agree(cmd, *self.mesh)

    def _key(self, rank: int) -> str:
        """The store key that tells follower `rank` that command number
        `self._commands` of this service is on its way."""
        return f"repro_torch/service/{self._channel}/{rank}/{self._commands}"

    def _receive(self):
        """A follower's next command: wait for its key on the store (no
        collective while the service idles), then join its broadcast."""
        from ..solver.distributed import agree
        store, key, pause = _store(), self._key(self.rank), _POLL_S[0]
        while not store.check([key]):
            time.sleep(pause)
            pause = min(2 * pause, _POLL_S[1])
        store.delete_key(key)
        return agree(None, *self.mesh)

    def _log(self, cmd) -> None:
        self._commands += 1
        kind, what = cmd[0], ""
        if kind == "admit":
            what = cmd[3][0]
        elif kind in ("batch", "tune"):
            what = cmd[1].pattern_fp
        self.mesh_log.append((kind, what[:8]))

    def _dispatch(self, batch) -> None:
        with self._cond:
            self._queued += 1
        self._pool.submit(self._run_queued, batch)

    def _run_queued(self, batch) -> None:
        with self._cond:
            self._queued -= 1
        self._run_batch(batch)

    def _tune_later(self) -> None:
        """The mesh thread's background tune: while a batch is queued or a
        request lingers it yields (re-queued behind them, after one linger
        when nothing is queued yet), so a cold pattern's first requests
        are served untuned and the tune runs when the thread is idle."""
        with self._cond:
            queued = self._queued > 0
            lingering = self._batcher.pending() > 0
        if (queued or lingering) and not self._closed:
            if not queued:
                time.sleep(self._batcher.max_linger_s)
            self._pool.submit(self._tune_later)
        else:
            self._tune_pending()

    def _tune_pending(self) -> int:
        """Run every deferred tune and its hot swap as a command (mesh
        thread, between batches); returns how many ran."""
        ran = 0
        for ekey in self.registry.pending_tunes():
            self._send(("tune", ekey))
            ran += bool(self.registry.run_tune(ekey))
        return ran

    def follow(self, on_batch=None) -> int:
        """Serve as a follower (a rank of the mesh other than its first):
        run rank 0's commands in rank 0's order until rank 0 closes the
        service, then close this one.  Returns the commands run.
        `on_batch(key, x)`, when given, receives each batch's solution on
        this rank.  The one entry point the reference lacks: torch's
        ranks are processes of their own, where JAX's mesh has one
        controller.  Every follower must call it, or rank 0's first
        command waits for it."""
        if self.mesh is None or self.rank == 0:
            raise RuntimeError("follow() runs on the ranks of a mesh other "
                               "than its first, which serves")
        while True:
            cmd = self._receive()
            self._log(cmd)
            if cmd[0] == "close":
                break
            try:
                self._apply(cmd, on_batch)
            except Exception as e:  # noqa: BLE001 - every rank agreed on
                # it, and rank 0 reports it to its callers; a follower
                # keeps following and counts its failed commands by kind
                # (a failed batch also in its stats)
                self._follow_errors[cmd[0]] += 1
                self._last_follow_error = f"{type(e).__name__}: {e}"
        self._closed = True
        if self._own_registry:
            self.registry.close()
        return self._commands

    def _apply(self, cmd, on_batch=None) -> None:
        """Run one of rank 0's commands on a follower."""
        kind = cmd[0]
        if kind == "admit":
            self._admitted(*cmd[1:])
        elif kind == "evict":
            for ekey in cmd[1]:
                self.registry.evict(ekey)
        elif kind == "tune":
            self.registry.run_tune(cmd[1])
        elif kind == "batch":
            x = self._follow_batch(*cmd[1:])
            if on_batch is not None:
                on_batch(cmd[1], x)
        else:
            raise ValueError(f"unknown mesh command {kind!r}")

    def _follow_batch(self, key, L_new, B, width: int, reason: str):
        t0 = self._clock()
        batch = Batch(key=key, requests=[None] * width, reason=reason)
        try:
            x = self._mesh_solve(key, L_new, B)
        except BaseException:
            self.stats.record_batch_error(batch)
            raise
        self.stats.record_batch(batch, [], (self._clock() - t0) * 1e3)
        return x

    def _mesh_solve(self, key, L_new, B):
        """A batch command's part on every rank: the entry and its re-bind
        to the batch's values (`L_new`, when the batch carries them),
        agreed; then the sharded solve, agreed.  After a re-bind that
        failed on any rank every rank re-binds at its next batch, so the
        ranks' operators stay bound alike."""
        from ..core.resilience import ShardedCallError
        from ..solver.distributed import settle

        def bind():
            entry = self._entry(key)
            if L_new is not None:
                entry.note_values(L_new, key.value_fp)
            return entry, entry.ensure_values(key.value_fp)

        try:
            entry, op = settle(bind, "its re-bind", *self.mesh)
        except ShardedCallError:
            entry = self.registry.get(_entry_key(key))
            if entry is not None:
                with entry.lock:
                    entry.bound_fp = ""
            raise
        with entry.lock, _obs.span("serving.solve", columns=B.shape[-1]
                                   if B.ndim == 2 else 1):
            return settle(lambda: op.solve(B, **self.solve_kwargs),
                          "its solve", *self.mesh)

    def solve(self, b, matrix, **kwargs) -> np.ndarray:
        """Synchronous sugar: submit and wait."""
        return self.submit(b, matrix, **kwargs).result()

    def _release(self, tenant: str) -> None:
        with self._tenant_lock:
            self._inflight[tenant] -= 1
            if self._inflight[tenant] <= 0:
                del self._inflight[tenant]

    def inflight(self, tenant: str | None = None) -> int:
        with self._tenant_lock:
            return sum(self._inflight.values()) if tenant is None \
                else self._inflight[tenant]

    # -- dispatch -------------------------------------------------------------
    def _dispatch_loop(self) -> None:
        while True:
            with self._cond:
                if self._closed:
                    batches = self._batcher.flush_all(self._clock())
                else:
                    now = self._clock()
                    deadline = self._batcher.next_deadline()
                    if deadline is None or deadline > now:
                        timeout = 0.05 if deadline is None \
                            else min(deadline - now, 0.05)
                        self._cond.wait(timeout=timeout)
                        continue
                    batches = self._batcher.due(now)
            for batch in batches:
                self._dispatch(batch)
            if self._closed:
                return

    def pump(self) -> int:
        """Drain every queued request synchronously on the calling thread
        (auto_dispatch=False mode); returns the number of batches run.
        Under a mesh the deferred tunes then run, after the batches."""
        with self._cond:
            batches, self._pending = self._pending, []
            batches += self._batcher.flush_all(self._clock())
        for batch in batches:
            self._run_batch(batch)
        if self.mesh is not None and not self._auto:
            self._tune_pending()
        return len(batches)

    def _entry(self, key):
        entry = self.registry.get(_entry_key(key))
        if entry is None:
            raise RuntimeError(
                f"no registry entry for pattern {key.pattern_fp[:8]} "
                f"(evicted mid-flight?)")
        return entry

    def _solve_batch(self, entry, value_fp: str, B):
        # one lock span covers re-bind + solve: a concurrent value update
        # or hot-swap lands before or after this batch, never inside it
        with entry.lock:
            op = entry.ensure_values(value_fp)
            with _obs.span("serving.solve", columns=B.shape[-1]
                           if B.ndim == 2 else 1):
                return op.solve(B, **self.solve_kwargs)

    def _run_batch(self, batch) -> None:
        t0 = self._clock()
        key = batch.key
        with _obs.span("serving.batch", width=batch.width,
                       reason=batch.reason,
                       pattern=key.pattern_fp[:8]) as bsp:
            # queue waits happened before this span on other threads;
            # record them retroactively as children (both ends measured on
            # the tracer's default perf_counter timebase)
            for r in batch.requests:
                _obs.record_span("serving.queue", r.t_enqueue, t0,
                                 parent=bsp, tenant=r.tenant)
            try:
                entry = self._entry(key)
                B = batch.stack()
                if self.pad_widths and B.ndim == 2:
                    bucket = 1 << (B.shape[1] - 1).bit_length()
                    if bucket > B.shape[1]:
                        B = np.concatenate(
                            [B, np.zeros((B.shape[0], bucket - B.shape[1]),
                                         dtype=B.dtype)], axis=1)
                        bsp.set(padded_width=bucket)
                if self.mesh is None:
                    x = self._solve_batch(entry, key.value_fp, B)
                else:
                    # the followers mirror rank 0's entry, bound to the same
                    # values: a re-bind's CSR travels with its batch
                    self._send(("batch", key, None
                                if key.value_fp == entry.bound_fp
                                else entry._values.get(key.value_fp), B,
                                batch.width, batch.reason))
                    x = self._mesh_solve(key, None, B)
            except BaseException as exc:  # noqa: BLE001 - resolve futures
                for r in batch.requests:
                    if r.future is not None and not r.future.done():
                        r.future.set_exception(exc)
                self.stats.record_batch_error(batch)
                return
            t1 = self._clock()
            for j, r in enumerate(batch.requests):
                if r.future is not None:
                    r.future.set_result(np.array(batch.column(x, j)))
            self.stats.record_batch(
                batch, [(t0 - r.t_enqueue) * 1e3 for r in batch.requests],
                (t1 - t0) * 1e3)
            bsp.set(solve_ms=(t1 - t0) * 1e3)

    # -- observability --------------------------------------------------------
    def snapshot(self) -> dict:
        """The stats plane; under a mesh also `mesh`: its size, this
        rank, its role, the commands sent or run and, on a follower, those
        that failed (a follower's counts are its own batches)."""
        snap = self.stats.snapshot(self.registry)
        if self.mesh is not None:
            snap["mesh"] = {"size": self.mesh_size, "rank": self.rank,
                            "role": "follower" if self.rank else "front",
                            "commands": self._commands,
                            "failed_commands": dict(self._follow_errors),
                            "last_error": self._last_follow_error}
        return snap

    def prometheus_text(self) -> str:
        """One Prometheus text page over every live metrics plane: the
        service's own registry, the operator registry's lifecycle
        counters, and each live entry's per-operator stats (labeled
        `entry=<pattern_fp[:8]>`)."""
        from ..obs.export import prometheus_text
        sources: list = [self.stats.registry]
        reg_metrics = getattr(self.registry, "metrics", None)
        if reg_metrics is not None:
            sources.append(reg_metrics)
        for ekey, entry in list(self.registry.entries()):
            op = entry.op
            if op is not None:
                sources.append((op.stats.registry,
                                {"entry": ekey.pattern_fp[:8]}))
        return prometheus_text(*sources)

    def wait_warm(self, timeout: float | None = None) -> bool:
        if self.mesh is not None and not self._auto and self.rank == 0:
            self._tune_pending()            # pump mode: run them here
        return self.registry.wait_warm(timeout)

    # -- lifecycle ------------------------------------------------------------
    def close(self, wait: bool = True) -> None:
        """Stop intake, drain queued batches, stop workers and tuner; under
        a mesh, then stop the followers (rank 0; a follower's service
        closes when its `follow()` returns)."""
        if self.rank != 0:
            return
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        if self._auto:
            self._dispatcher.join(timeout=5.0)
            # under a mesh the mesh thread must finish before close's own
            # command: no two threads issue collectives at once
            self._pool.shutdown(wait=wait or self.mesh is not None)
        else:
            self.pump()
        if self.mesh is not None:
            self._send(("close",))
        if self._own_registry:
            self.registry.close(wait=wait)

    def __enter__(self) -> "SolveService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
