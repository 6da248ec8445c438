"""repro_torch.obs — the observability layer (port of `repro.obs`).

* `trace`   — structured nested spans over the solve path; no-op unless
  enabled (`obs.enable()` / `REPRO_TRACE=1`); `annotate_torch=True`
  mirrors every span into a `torch.profiler` trace.
* `metrics` — the counters/gauges/histograms registry every stats plane
  (`OperatorStats`, `ServiceStats`, the registry's lifecycle counters,
  the portfolio's tune counters) is a view over.
* `profile` — the per-step schedule profiler (K1's stamped form on the
  card); feeds `CostModel.calibrate` (`calibrate`).
* `export`  — Chrome trace-event, JSON-lines, and Prometheus text
  exporters plus their validators.

Quick trace of a solve::

    from repro_torch import obs
    obs.enable()
    op.solve(b)
    obs.export.write_chrome_trace("solve.trace.json", obs.get_tracer())

`profile` is loaded lazily: it needs `repro_torch.solver`, which itself
traces through this package — eager import here would be a cycle.
`profile.ProfilingEngine` wraps an engine and leaves a per-step profile
of every solve it serves.
"""
from __future__ import annotations

import importlib

from . import export, metrics, trace
from .metrics import MetricsRegistry, default_registry
from .trace import (NULL_SPAN, Span, Tracer, disable, enable, enabled,
                    event, get_tracer, record_span, span)

__all__ = ["trace", "metrics", "export", "profile",
           "Span", "Tracer", "enable", "disable", "enabled", "get_tracer",
           "span", "event", "record_span", "NULL_SPAN",
           "MetricsRegistry", "default_registry"]


def __getattr__(name):
    if name == "profile":
        mod = importlib.import_module(".profile", __name__)
        globals()["profile"] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
