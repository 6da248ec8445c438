"""Multi-tenant SpTRSV solve service on torch devices (port of
`repro.serving`).

Layers, bottom-up:

* `batcher`  — pure-logic micro-batching: same-fingerprint requests
  coalesce into one (n, k) solve under a width/linger flush policy.
* `registry` — warm-cache admission: cold patterns serve immediately via
  an untuned build, the `StrategyPortfolio` tunes in the background, and
  the tuned operator hot-swaps atomically; value-only refreshes re-bind
  through `TriangularOperator.update_values`.
* `service`  — the front door: `submit()` futures, per-tenant in-flight
  caps (typed `AdmissionError`), worker pool, `ServiceStats`.
* `server`   — `python -m repro_torch.serving.server`: a synthetic mixed
  workload generator for smoke-testing a live service on the card
  (`--device cpu` for the host path).
"""
from ..core.resilience import AdmissionError, TunerFailureWarning
from .batcher import Batch, BatchKey, MicroBatcher, SolveRequest
from .registry import EntryKey, OperatorEntry, OperatorRegistry
from .service import ServiceStats, SolveService

__all__ = [
    "Batch", "BatchKey", "MicroBatcher", "SolveRequest",
    "EntryKey", "OperatorEntry", "OperatorRegistry",
    "ServiceStats", "SolveService",
    "AdmissionError", "TunerFailureWarning",
]
