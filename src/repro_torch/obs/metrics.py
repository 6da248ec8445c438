"""Metrics registry: counters, gauges, histograms, and info text.

Port of `repro.obs.metrics`: the same instruments, names and prefixes,
so that the two packages' snapshots and Prometheus pages read alike.

The single backing store for every stats plane in the repo:
`OperatorStats` (solver/operator.py), `ServiceStats` and the registry
lifecycle counters (serving/), and the portfolio's tune/measure-note
counters are all *views* over instruments held in a `MetricsRegistry` —
their `to_dict()`/`snapshot()` read the instruments, nothing is counted
twice.

Thread-safety follows `OperatorStats`' discipline: ONE re-entrant lock
per registry, shared by every instrument it owns, so a multi-instrument
commit (`record_solve` bumps solves + total_solve_ms + ... in one
acquisition) is atomic — `solves` and `total_solve_ms` always describe
the same set of solves.  Reads of a single instrument are committed
values; whole-registry snapshots take the lock once.

Instruments support Prometheus-style labels (`counter.inc(reason="width")`)
stored as sorted key/value tuples, and histograms carry FIXED bucket
boundaries plus an optional bounded sample reservoir for nearest-rank
percentiles (the exact formula `ServiceStats` has always used).
Exporters live in `repro_torch.obs.export` (Prometheus text, JSON).
"""
from __future__ import annotations

import threading

__all__ = ["MetricsRegistry", "Counter", "Gauge", "Text", "Histogram",
           "default_registry", "nearest_rank_percentile",
           "DEFAULT_MS_BUCKETS"]

# latency-style boundaries (milliseconds), upper-inclusive like
# Prometheus `le`; the overflow bucket is implicit (+Inf)
DEFAULT_MS_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
                      50.0, 100.0, 250.0, 1000.0, 5000.0)


def nearest_rank_percentile(samples, q: float) -> float:
    """Nearest-rank percentile of a sequence (NaN when empty) — the ONE
    formula of the serving stats plane."""
    if not samples:
        return float("nan")
    s = sorted(samples)
    rank = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
    return float(s[rank])


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class _Instrument:
    """Shared shape: named, labeled series, registry-owned lock."""

    kind = "abstract"

    def __init__(self, name: str, help: str, lock):
        self.name = name
        self.help = help
        self._lock = lock
        self._series: dict = {}

    def series(self) -> dict:
        """Copy of label-tuple -> value (histograms: -> state dict)."""
        with self._lock:
            return dict(self._series)

    def labels(self) -> list:
        with self._lock:
            return list(self._series)


class Counter(_Instrument):
    """Monotonic counter (int or float increments)."""

    kind = "counter"

    def inc(self, n=1, **labels) -> None:
        k = _label_key(labels)
        with self._lock:
            self._series[k] = self._series.get(k, 0) + n

    def value(self, **labels):
        with self._lock:
            return self._series.get(_label_key(labels), 0)

    def total(self):
        """Sum over every labeled series."""
        with self._lock:
            return sum(self._series.values())


class Gauge(_Instrument):
    """Last-write-wins value; `default` is what value() reads before any
    set (0.0 unless configured, e.g. NaN for last_residual)."""

    kind = "gauge"

    def __init__(self, name, help, lock, default: float = 0.0):
        super().__init__(name, help, lock)
        self.default = default

    def set(self, v, **labels) -> None:
        with self._lock:
            self._series[_label_key(labels)] = v

    def add(self, v, **labels) -> None:
        k = _label_key(labels)
        with self._lock:
            self._series[k] = self._series.get(k, self.default) + v

    def value(self, **labels):
        with self._lock:
            return self._series.get(_label_key(labels), self.default)


class Text(_Instrument):
    """String-valued info instrument (cache_source, last_fallback, ...).
    Prometheus export renders it as `<name>_info{value="..."} 1`."""

    kind = "text"

    def set(self, s: str, **labels) -> None:
        with self._lock:
            self._series[_label_key(labels)] = str(s)

    def value(self, **labels) -> str:
        with self._lock:
            return self._series.get(_label_key(labels), "")


class Histogram(_Instrument):
    """Fixed-boundary histogram + optional bounded sample reservoir.

    Per labeled series: bucket counts (one per boundary, upper-inclusive,
    plus the implicit +Inf overflow), running sum and count, and — when
    `reservoir > 0` — the first `reservoir` raw samples for nearest-rank
    percentiles.  The reservoir STOPS admitting at capacity (it is a
    bounded memory guarantee, not a sliding window), exactly like the
    latency lists `ServiceStats` kept before this module existed.
    """

    kind = "histogram"

    def __init__(self, name, help, lock, bounds=DEFAULT_MS_BUCKETS,
                 reservoir: int = 0):
        super().__init__(name, help, lock)
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(self.bounds):
            raise ValueError(f"histogram bounds must be sorted: {bounds}")
        self.reservoir = int(reservoir)

    def _state(self, k):
        st = self._series.get(k)
        if st is None:
            st = self._series[k] = {
                "buckets": [0] * (len(self.bounds) + 1),
                "sum": 0.0, "count": 0,
                "samples": [] if self.reservoir else None}
        return st

    def observe(self, v: float, **labels) -> None:
        v = float(v)
        k = _label_key(labels)
        with self._lock:
            st = self._state(k)
            i = 0
            for i, b in enumerate(self.bounds):
                if v <= b:
                    break
            else:
                i = len(self.bounds)
            st["buckets"][i] += 1
            st["sum"] += v
            st["count"] += 1
            if st["samples"] is not None and \
                    len(st["samples"]) < self.reservoir:
                st["samples"].append(v)

    def count(self, **labels) -> int:
        with self._lock:
            st = self._series.get(_label_key(labels))
            return 0 if st is None else st["count"]

    def sum(self, **labels) -> float:
        with self._lock:
            st = self._series.get(_label_key(labels))
            return 0.0 if st is None else st["sum"]

    def samples(self, **labels) -> list:
        with self._lock:
            st = self._series.get(_label_key(labels))
            return [] if st is None or st["samples"] is None \
                else list(st["samples"])

    def percentile(self, q: float, **labels) -> float:
        """Nearest-rank percentile over the reservoir (NaN when empty or
        reservoir-less)."""
        return nearest_rank_percentile(self.samples(**labels), q)

    def buckets(self, **labels) -> dict:
        """{upper_bound: count} (non-cumulative), +Inf as float('inf')."""
        with self._lock:
            st = self._series.get(_label_key(labels))
            counts = [0] * (len(self.bounds) + 1) if st is None \
                else list(st["buckets"])
        edges = list(self.bounds) + [float("inf")]
        return dict(zip(edges, counts))


class MetricsRegistry:
    """Named instruments behind one shared lock (module doc).

    `prefix` namespaces the exported metric names ("repro_operator", ...);
    instrument names themselves stay short snake_case ("solves").
    get-or-create accessors return the existing instrument when the name
    is already registered (and raise if it was registered as another
    kind), so independent views can share a backing series safely.
    """

    def __init__(self, prefix: str = "repro"):
        self.prefix = prefix
        self._lock = threading.RLock()
        self._metrics: dict = {}

    @property
    def lock(self):
        """The shared lock, for multi-instrument atomic commits."""
        return self._lock

    def _get_or_create(self, cls, name, help, **kw):
        with self._lock:
            inst = self._metrics.get(name)
            if inst is not None:
                if not isinstance(inst, cls):
                    raise TypeError(
                        f"metric {name!r} already registered as "
                        f"{inst.kind}, not {cls.kind}")
                return inst
            inst = self._metrics[name] = cls(name, help, self._lock, **kw)
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "",
              default: float = 0.0) -> Gauge:
        return self._get_or_create(Gauge, name, help, default=default)

    def text(self, name: str, help: str = "") -> Text:
        return self._get_or_create(Text, name, help)

    def histogram(self, name: str, help: str = "",
                  bounds=DEFAULT_MS_BUCKETS,
                  reservoir: int = 0) -> Histogram:
        return self._get_or_create(Histogram, name, help, bounds=bounds,
                                   reservoir=reservoir)

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def collect(self) -> list:
        """Every registered instrument (stable registration order)."""
        with self._lock:
            return list(self._metrics.values())

    def snapshot(self) -> dict:
        """JSON-friendly dump: name -> {kind, series} with label tuples
        rendered as 'k=v,k2=v2' strings ('' for the unlabeled series)."""
        out = {}
        with self._lock:
            for name, inst in self._metrics.items():
                series = {
                    ",".join(f"{k}={v}" for k, v in key): val
                    for key, val in inst.series().items()}
                out[name] = {"kind": inst.kind, "series": series}
        return out


_DEFAULT = MetricsRegistry(prefix="repro")


def default_registry() -> MetricsRegistry:
    """The process-wide registry (portfolio counters and other module-level
    producers land here; per-object stats planes own their own)."""
    return _DEFAULT
