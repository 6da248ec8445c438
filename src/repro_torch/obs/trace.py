"""Structured tracing: nested spans over the solve path, off by default.

Port of `repro.obs.trace`; span and event names, ids, parenting and the
exporters' documents are the reference's.

A `Span` is a named, timed interval with attributes and point-in-time
events; spans nest via a per-thread stack so `operator.solve` opened
inside `serving.batch` records the right parent without any plumbing.
The taxonomy of span/event names is the reference's (its
docs/observability.md).

Two disciplines carried over from the rest of the repo:

* **Injected clocks** — a `Tracer` takes `clock=` at construction
  (default `time.perf_counter`, the same timebase `SolveService._clock`
  uses) and never calls a clock the caller didn't hand it, matching the
  micro-batcher's testable-time rule.  Tests drive traces with fake
  clocks and assert exact durations.
* **No-op unless enabled** — the module-level `span()`/`event()` helpers
  that production code calls consult one global; when no tracer is
  installed they return a shared do-nothing span and read no clock, so
  the hot path pays one global read + one method call.  Enable
  explicitly via `obs.enable()` or by setting `REPRO_TRACE` in the
  environment before import.

Cross-thread intervals that cannot use a `with` block (a request's queue
wait starts on the submitting thread and ends on the batch thread) are
recorded retroactively with `record_span(name, t_start, t_end, parent=)`.

When a tracer is built with `annotate_torch=True`, each span also enters a
`torch.profiler.record_function` of the same name, so that spans line up
with the kernels in a `torch.profiler` trace (it records only while a
profiler runs).
"""
from __future__ import annotations

import itertools
import os
import threading
import time

__all__ = ["Span", "Tracer", "enable", "disable", "enabled", "get_tracer",
           "span", "event", "record_span", "NULL_SPAN"]


class Span:
    """One timed interval. Created by `Tracer.span(...)`; use as a
    context manager. Ids/parenting are assigned at `__enter__` (that is
    when the per-thread stack position is known)."""

    __slots__ = ("name", "attrs", "events", "span_id", "parent_id",
                 "t_start", "t_end", "tid", "_tracer", "_torch_ctx")

    def __init__(self, name, attrs, tracer):
        self.name = name
        self.attrs = dict(attrs)
        self.events = []
        self.span_id = None
        self.parent_id = None
        self.t_start = None
        self.t_end = None
        self.tid = None
        self._tracer = tracer
        self._torch_ctx = None

    def __enter__(self):
        tr = self._tracer
        stack = tr._stack()
        self.parent_id = stack[-1].span_id if stack else None
        self.tid = threading.get_ident()
        with tr._lock:
            self.span_id = next(tr._ids)
            tr._open[self.span_id] = self
        stack.append(self)
        if tr.annotate_torch:
            self._torch_ctx = tr._torch_annotation(self.name)
            self._torch_ctx.__enter__()
        self.t_start = tr.clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        tr = self._tracer
        self.t_end = tr.clock()
        if self._torch_ctx is not None:
            self._torch_ctx.__exit__(exc_type, exc, tb)
            self._torch_ctx = None
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        stack = tr._stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:          # exited out of order; keep nesting sane
            stack.remove(self)
        with tr._lock:
            tr._open.pop(self.span_id, None)
            if len(tr._finished) < tr.max_spans:
                tr._finished.append(self)
        return False

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def event(self, name: str, **attrs) -> None:
        """Point-in-time marker inside this span."""
        self.events.append((name, self._tracer.clock(), attrs))

    @property
    def duration(self) -> float:
        if self.t_start is None or self.t_end is None:
            return float("nan")
        return self.t_end - self.t_start

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.span_id}, "
                f"parent={self.parent_id}, dur={self.duration:.6f})")


class _NullSpan:
    """Shared do-nothing span returned when tracing is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self

    def event(self, name=None, **attrs):
        pass


NULL_SPAN = _NullSpan()


class Tracer:
    """Collects finished spans (bounded by `max_spans`) plus orphan
    events that fired outside any span. Thread-safe; span nesting is
    tracked per thread."""

    def __init__(self, clock=time.perf_counter, max_spans: int = 200_000,
                 annotate_torch: bool = False):
        self.clock = clock
        self.max_spans = int(max_spans)
        self.annotate_torch = bool(annotate_torch)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._open: dict = {}
        self._finished: list = []
        self._orphans: list = []

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @staticmethod
    def _torch_annotation(name):
        from torch.profiler import record_function
        return record_function(name)

    def span(self, name: str, **attrs) -> Span:
        return Span(name, attrs, self)

    def event(self, name: str, **attrs) -> None:
        """Attach to the current span, else record as an orphan."""
        stack = self._stack()
        if stack:
            stack[-1].event(name, **attrs)
            return
        with self._lock:
            if len(self._orphans) < self.max_spans:
                self._orphans.append(
                    (name, self.clock(), attrs, threading.get_ident()))

    def record_span(self, name: str, t_start: float, t_end: float, *,
                    parent=None, tid=None, **attrs) -> Span:
        """Retroactively record an interval measured elsewhere (module
        doc: cross-thread queue waits). `parent` is a Span or span id."""
        sp = Span(name, attrs, self)
        sp.t_start = float(t_start)
        sp.t_end = float(t_end)
        if isinstance(parent, Span):
            parent = parent.span_id
        elif not isinstance(parent, (int, type(None))):
            parent = None            # e.g. NULL_SPAN from a mid-flight enable
        sp.parent_id = parent
        sp.tid = threading.get_ident() if tid is None else tid
        with self._lock:
            sp.span_id = next(self._ids)
            if len(self._finished) < self.max_spans:
                self._finished.append(sp)
        return sp

    def current_span(self):
        stack = self._stack()
        return stack[-1] if stack else None

    def spans(self) -> list:
        with self._lock:
            return list(self._finished)

    def orphan_events(self) -> list:
        with self._lock:
            return list(self._orphans)

    def open_spans(self) -> list:
        """Spans entered but not yet exited — must be empty at export
        time for a trace to validate."""
        with self._lock:
            return list(self._open.values())

    def reset(self) -> None:
        with self._lock:
            self._finished.clear()
            self._orphans.clear()


# ----------------------------------------------------------------------
# process-wide default tracer (module doc: one global read when disabled)

_TRACER: Tracer | None = None


def enable(tracer: Tracer | None = None, **kw) -> Tracer:
    """Install `tracer` (or a fresh `Tracer(**kw)`) as the process-wide
    default and return it."""
    global _TRACER
    _TRACER = tracer if tracer is not None else Tracer(**kw)
    return _TRACER


def disable() -> Tracer | None:
    """Uninstall and return the active tracer (None if none was)."""
    global _TRACER
    tr, _TRACER = _TRACER, None
    return tr


def enabled() -> bool:
    return _TRACER is not None


def get_tracer() -> Tracer | None:
    return _TRACER


def span(name: str, **attrs):
    """`with obs.span("operator.solve", n=n):` — NULL_SPAN when off."""
    tr = _TRACER
    if tr is None:
        return NULL_SPAN
    return tr.span(name, **attrs)


def event(name: str, **attrs) -> None:
    tr = _TRACER
    if tr is not None:
        tr.event(name, **attrs)


def record_span(name: str, t_start: float, t_end: float, *,
                parent=None, **attrs):
    tr = _TRACER
    if tr is None:
        return NULL_SPAN
    return tr.record_span(name, t_start, t_end, parent=parent, **attrs)


if os.environ.get("REPRO_TRACE", "") not in ("", "0"):
    enable()
