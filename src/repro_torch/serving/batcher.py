"""Micro-batching scheduler: coalesce concurrent solves into (n, k) blocks.

Port of `repro.serving.batcher`.  The cheapest parallelism the stack owns
is the batched right-hand side: the SpTRSV kernel streams the compiled
schedule ONCE for all k columns of an (n, k) solve (K2,
`kernels.sptrsv_level.sptrsv_groups_multi`), so k concurrent requests
against the same operator cost barely more than one (the per-step
latency and the host's launch are amortized over the whole block).
This module turns that into a serving-tier policy:
requests sharing a `BatchKey` (pattern fingerprint, value fingerprint,
dtype, sweep orientation) are coalesced into one batch, flushed by the
first of two deterministic triggers:

* **width flush** — the key reaches `max_width` pending requests: the
  batch is returned synchronously from `enqueue()` (the k-th submitter
  pays zero linger).
* **linger flush** — the OLDEST pending request of a key reaches its
  deadline (`t_enqueue + max_linger_s`): `due(now)` returns the batch.
  `next_deadline()` tells the caller when to poll next.

The scheduler is PURE LOGIC: time enters only as the `now` argument, no
clock is read, no thread is spawned, and no locking happens here (the
owning `SolveService` serializes access).  That makes the flush policy
unit-testable without wall-clock races — a property suite drives it
with synthetic clocks and asserts the three invariants every batch must
satisfy:

1. a batch never mixes keys (fingerprints, dtypes, orientations),
2. no request lingers past its deadline (given `due` is polled at or
   after `next_deadline()`),
3. FIFO holds within a key: requests are batched in enqueue order, and
   no later request of a key is served before an earlier one.

Batches retain per-request enqueue metadata so the service can split
queue latency (enqueue -> dispatch) from solve latency in its stats.

One deliberate difference from the reference: `due` orders keys whose
oldest deadlines tie by that request's enqueue sequence number.  The
reference sorts (deadline, BatchKey) tuples and raises TypeError on a
tie, since BatchKey defines no order.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np

__all__ = ["BatchKey", "SolveRequest", "Batch", "MicroBatcher"]


@dataclasses.dataclass(frozen=True)
class BatchKey:
    """What may legally share one batched solve.

    Two requests coalesce only when every field matches: the pattern
    fingerprint pins the schedule/tuner artifact, the value fingerprint
    pins the numeric payload (a value update is a NEW key — in-flight
    requests against the old values keep their own batch), dtype pins the
    device math, and side/transpose pin the sweep orientation.
    """

    pattern_fp: str
    value_fp: str
    dtype: str = "float32"
    side: str = "lower"
    transpose: bool = False


@dataclasses.dataclass
class SolveRequest:
    """One tenant's solve against an admitted operator.

    `seq`, `t_enqueue`, and `deadline` are assigned by the batcher at
    enqueue time; `future` is attached by the service (None for direct
    batcher use).  `b` must be a 1-D right-hand side of the operator's n.
    """

    key: BatchKey
    b: np.ndarray
    tenant: str = "default"
    seq: int = -1
    t_enqueue: float = 0.0
    deadline: float = 0.0
    future: object = None


@dataclasses.dataclass
class Batch:
    """An ordered group of same-key requests, ready to solve as (n, k)."""

    key: BatchKey
    requests: list
    t_flush: float = 0.0        # the `now` at which the batch was formed
    reason: str = ""            # "width" | "linger" | "drain"

    @property
    def width(self) -> int:
        return len(self.requests)

    def stack(self) -> np.ndarray:
        """The batched right-hand side: (n,) for one request, (n, k) in
        enqueue order otherwise — column j belongs to requests[j]."""
        if len(self.requests) == 1:
            return np.asarray(self.requests[0].b)
        return np.stack([np.asarray(r.b) for r in self.requests], axis=1)

    def column(self, x: np.ndarray, j: int) -> np.ndarray:
        """requests[j]'s slice of a solved stack()."""
        return x if x.ndim == 1 else x[:, j]


class MicroBatcher:
    """Deterministic width/linger batching over per-key FIFO queues.

    max_width:    flush a key the moment it holds this many requests
                  (also the widest batch ever returned).
    max_linger_s: the longest any request may wait for co-batchable
                  traffic; a request enqueued at t has deadline
                  t + max_linger_s, and `due(now)` flushes every key whose
                  oldest deadline is <= now.  0 disables lingering —
                  every enqueue returns a width-1 batch immediately.
    """

    def __init__(self, max_width: int = 16, max_linger_s: float = 0.002):
        if max_width < 1:
            raise ValueError(f"max_width must be >= 1, got {max_width}")
        if max_linger_s < 0:
            raise ValueError(
                f"max_linger_s must be >= 0, got {max_linger_s}")
        self.max_width = max_width
        self.max_linger_s = max_linger_s
        self._queues: "collections.OrderedDict[BatchKey, collections.deque]" \
            = collections.OrderedDict()
        self._seq = 0

    # -- enqueue / flush ------------------------------------------------------
    def enqueue(self, req: SolveRequest, now: float) -> Batch | None:
        """Add a request at time `now`; returns the full-width batch when
        this request is the max_width-th of its key (or a width-1 batch
        when lingering is disabled), else None."""
        self._seq += 1
        req.seq = self._seq
        req.t_enqueue = now
        req.deadline = now + self.max_linger_s
        q = self._queues.get(req.key)
        if q is None:
            q = self._queues[req.key] = collections.deque()
        q.append(req)
        if len(q) >= self.max_width or self.max_linger_s == 0:
            return self._flush_key(req.key, now, "width")
        return None

    def due(self, now: float) -> list:
        """Flush every key whose oldest request's deadline is <= now, in
        deadline order, a tie going to the earlier enqueued request.
        Idempotent between enqueues: a flushed key holds nothing, so
        calling again returns []."""
        ready = sorted(
            (q[0].deadline, q[0].seq, key) for key, q in self._queues.items()
            if q and q[0].deadline <= now)
        return [self._flush_key(key, now, "linger") for _, _, key in ready]

    def flush_all(self, now: float = float("inf")) -> list:
        """Drain every pending request regardless of deadline (service
        shutdown / deterministic pump), oldest key first."""
        keys = [key for key, q in self._queues.items() if q]
        keys.sort(key=lambda k: self._queues[k][0].seq)
        return [self._flush_key(key, now, "drain") for key in keys]

    def _flush_key(self, key: BatchKey, now: float, reason: str) -> Batch:
        q = self._queues[key]
        take = min(len(q), self.max_width)
        reqs = [q.popleft() for _ in range(take)]
        if not q:
            del self._queues[key]
        return Batch(key=key, requests=reqs, t_flush=now, reason=reason)

    # -- introspection --------------------------------------------------------
    def pending(self) -> int:
        """Total requests currently queued across all keys."""
        return sum(len(q) for q in self._queues.values())

    def pending_keys(self) -> int:
        return sum(1 for q in self._queues.values() if q)

    def next_deadline(self) -> float | None:
        """The earliest pending deadline — when `due()` next has work —
        or None when nothing is queued."""
        deadlines = [q[0].deadline for q in self._queues.values() if q]
        return min(deadlines) if deadlines else None
