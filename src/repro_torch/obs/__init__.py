"""Observability: the per-step schedule profiler (port of `repro.obs`'s
`profile` module) and the calibration of the tuner's cost constants
from it (`calibrate`).  Tracing, the metrics registry and the exporters
are not ported yet (ROADMAP.md, queue 1: observability)."""
from .profile import (ScheduleProfile, merge_profiles, profile_operator,
                      profile_schedule)

__all__ = ["ScheduleProfile", "profile_schedule", "profile_operator",
           "merge_profiles"]
