"""Static verification of compiled solve artifacts.

Copy of `repro.analysis` (numpy and the standard library only), plus the
certifier of the SpTRSV kernel's packed form.  Two passes, both
zero-execution:

* `repro_torch.analysis.verify` — the schedule race detector + invariant
  certifier: vectorized O(nnz) structural checks over `LevelSchedule` /
  `DeviceSchedule` (every dependency and carry segment produced strictly
  earlier, lane/row bijection, index bounds, padding sentinels, dtype
  flow) returning a typed `ScheduleCertificate`, the transform auditor
  over `TransformedSystem` / `ReplayPlan` commit logs, and the same
  guarantees for what the card runs: the packed tile stream
  (`verify_packed_schedule`) and a device refresh of its values
  (`verify_packed_values`), each returning a `PackedCertificate`.
* `repro_torch.analysis.lint` — the repo-rule AST lint encoding the house
  invariants: no host callbacks in traced loop bodies, injected clocks
  only in the pure scheduling tiers, memo mutation only under its lock,
  engines gate dtypes, no bare except.
"""
from .verify import (PackedCertificate, ScheduleCertificate,
                     audit_transformed_system, certificate_dict,
                     verify_level_schedule, verify_operator_payload,
                     verify_packed_schedule, verify_packed_values,
                     verify_schedule_values)
from .lint import Finding, lint_paths, lint_source

__all__ = [
    "ScheduleCertificate", "audit_transformed_system", "certificate_dict",
    "verify_level_schedule", "verify_operator_payload",
    "verify_schedule_values", "PackedCertificate", "verify_packed_schedule",
    "verify_packed_values",
    "Finding", "lint_paths", "lint_source",
]
