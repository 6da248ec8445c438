"""Strategy lookup by stable name.

Copy of `STRATEGY_REGISTRY` and `make_strategy` from
`repro.core.portfolio`.  The portfolio auto-tuner itself (`tune="auto"`)
is not ported yet (ROADMAP.md, queue 1).
"""
from __future__ import annotations

from .strategies import (AvgLevelCost, ConstrainedAvgLevelCost,
                         CriticalPathRewrite, ManualEveryK, NoRewrite,
                         Strategy)

__all__ = ["make_strategy", "STRATEGY_REGISTRY"]

# stable strategy name -> zero-arg-constructible class (docs/strategies.md)
STRATEGY_REGISTRY = {
    "no_rewriting": NoRewrite,
    "avgLevelCost": AvgLevelCost,
    "manual_every_k": ManualEveryK,
    "constrained_avg": ConstrainedAvgLevelCost,
    "critical_path": CriticalPathRewrite,
}


def make_strategy(spec) -> Strategy:
    """Resolve a strategy spec: a Strategy instance passes through, a stable
    name string (see STRATEGY_REGISTRY) constructs the default instance."""
    if isinstance(spec, str):
        try:
            return STRATEGY_REGISTRY[spec]()
        except KeyError:
            raise ValueError(
                f"unknown strategy {spec!r}; expected one of "
                f"{sorted(STRATEGY_REGISTRY)} or a Strategy instance") from None
    if not hasattr(spec, "apply"):
        raise TypeError(f"not a Strategy: {spec!r}")
    return spec
