"""Schedule race detector + invariant certifier.

Copy of `repro.analysis.verify` (numpy host half; tests hold the two
equal), plus the certifier of what the port's SpTRSV kernel actually
reads.

The paper's premise is that the transformed dependency graph stays
*equivalent* while gaining parallelism.  Dynamic checks (sampled solves
against the host oracle, residual guards) can only catch a bad schedule
after it has produced a wrong answer; this module proves the structural
half statically, before anything executes:

* `verify_level_schedule` — vectorized O(nnz) checks over a
  `LevelSchedule` (or a `DeviceSchedule`, via its host back-pointer):
  every ELL dependency and carry segment is produced at a strictly
  earlier step (scheduling-race detection, split-row carry chains
  included), every row is finalized exactly once (lane/row bijection),
  every ELL / carry / value-plan index is in bounds with padding lanes
  fully inert, the numeric payload is finite with `dinv` bitwise equal
  to `1/diag` in the schedule dtype, and width buckets are well-formed.
  Returns a `ScheduleCertificate` carrying the *certified* quality
  metrics — step count, critical-path length, cross-device edge count.
  Violations raise `ScheduleInvariantError` naming the check, step, and
  lane.
* `audit_transformed_system` — the transform auditor: triangularity of
  the rewritten system, level monotonicity along every dependency edge,
  fill accounting against `TransformMetrics`, T-factor source
  monotonicity, and `ReplayPlan` commit bounds.  Violations raise
  `TransformInvariantError`.
* `verify_schedule_values` — the cheap value-only re-audit the
  `update_values` refactorization fast path runs under strict health:
  packed-nnz accounting, payload finiteness, and `dinv` agreement on a
  structure that was already certified at build time.

The card does not run the `LevelSchedule`: the CUDA kernel reads the
packed tile stream `kernels.sptrsv_level.pack_groups` makes of it (carry
chains fused, re-levelled to the DAG's depth, tiles cut for the TMA ring,
rows longer than a tile moved to `far`, the first level moved to the free
pass).  So certifying the schedule does not certify what runs, and the
port adds:

* `verify_packed_schedule` — decodes the packed form (`unpack_tiles`,
  after checking every offset it follows) and proves, vectorised over
  lanes: the tile stream's shape (tile pointers, stage bytes, headers,
  flags consistent with the lanes' `last` bits), index bounds (rows,
  deps, tile and `far` offsets), the row bijection over the free pass and
  the tiles, the race invariant on the decoded steps (the kernel's step
  boundaries), the step count, the long-lane layout, and per row the
  (index, coefficient) pairs and 1/diag against the schedule's, bitwise
  in float32; and the pack's `ValueMap`: each word it names is a value
  word of the stream, each once, whose source slot holds that word's
  pair or 1/diag.  Returns a `PackedCertificate`.
* `verify_packed_values` — after a device refresh of a packed form's
  values (`refresh_packed_values`), reads back just the rewritten words
  through the pack's `ValueMap` (one gather on the device, one copy to
  the host, O(nnz)) and checks them against the new float32 values.
  The map was certified with the structure, so the words read back are
  the ones the kernel reads.

`solver.schedule.validate_schedule` is a thin shim over
`verify_level_schedule` (one implementation); strict-mode operator
builds call the verifiers once per built artifact and keep the
certificates on the cached payload, so cache hits re-verify nothing.
`verify_collectives` (`collectives=True`) certifies the sharded
lowering's collective structure through `solver.distributed.
count_all_gathers`: one all_gather family per schedule step.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.resilience import ScheduleInvariantError, TransformInvariantError

__all__ = [
    "ScheduleCertificate", "certificate_dict", "verify_level_schedule",
    "verify_schedule_values", "audit_transformed_system",
    "verify_operator_payload", "PackedCertificate", "verify_packed_schedule",
    "verify_packed_values",
]

#: checks verify_level_schedule runs, in order (certificate.checks)
STRUCTURAL_CHECKS = (
    "shape", "index-bounds", "padding", "bijection", "race", "carry-order",
    "dtype", "value-plan",
)
VALUE_CHECKS = ("nnz", "finite", "dinv")


@dataclasses.dataclass(frozen=True)
class ScheduleCertificate:
    """Proof-carrying summary of one verified LevelSchedule.

    Every field is derived during verification, so citing it is citing a
    *certified* quantity (docs/analysis.md lists the invariant catalog):

    n / nnz:        system size and packed nonzero count (== matrix nnz).
    steps:          certified step count — every dependency crosses a step
                    boundary, so `steps` barriers are sufficient.
    levels:         level count of the input assignment (steps <= levels
                    for compacted schedules).
    critical_path:  longest dependency chain through lanes and carry
                    segments, in steps — no schedule for this lane split
                    can use fewer steps, so `steps - critical_path` is the
                    certified compaction slack.
    cross_device_edges: dependency edges whose producer and consumer lanes
                    live on different devices under block lane sharding
                    over `devices` devices (0 when devices == 1) — the
                    quantity the communication-avoiding partitioner must
                    minimize.
    devices:        device count the cross-device count was computed for.
    n_carry:        carry slots (split-row chains).
    group_widths:   ELL width buckets.
    flops / padded_flops: real and padded work (== LevelSchedule.flops()/
                    padded_flops(), re-derived from the verified tiles).
    dtype:          schedule value dtype name.
    collective_families: per-step all_gather families counted on the
                    sharded lowering, or None when the collectives check
                    was skipped (always, until the sharded lowering is
                    ported).
    checks:         names of the checks that ran.
    """

    n: int
    nnz: int
    steps: int
    levels: int
    critical_path: int
    cross_device_edges: int
    devices: int
    n_carry: int
    group_widths: tuple
    flops: int
    padded_flops: int
    dtype: str
    collective_families: int | None
    checks: tuple


def certificate_dict(cert: ScheduleCertificate) -> dict:
    """JSON-able view (BENCH_schedule's per-matrix `certificate` block)."""
    d = dataclasses.asdict(cert)
    d["group_widths"] = list(cert.group_widths)
    d["checks"] = list(cert.checks)
    return d


def _host(sched):
    """Unwrap a DeviceSchedule to its host LevelSchedule."""
    return getattr(sched, "host", sched)


def _fail(msg, *, check, step=-1, lane=-1, group=-1, where=""):
    raise ScheduleInvariantError(msg, check=check, step=step, lane=lane,
                                 group=group, where=where)


def _first_bad(mask):
    """(step, lane) of the first True in a (S, C[, D]) mask."""
    idx = np.argwhere(mask)[0]
    return int(idx[0]), int(idx[1])


def _check_shapes(sched, where):
    S = sched.num_steps
    prev_w = 0
    for gi, g in enumerate(sched.groups):
        s, c = g.row_ids.shape
        if s != S:
            _fail(f"group {gi} has {s} steps, group 0 has {S}",
                  check="shape", group=gi, where=where)
        if g.dep_idx.shape != (s, c, g.width) or \
                g.dep_coef.shape != g.dep_idx.shape or \
                g.dinv.shape != (s, c):
            _fail(f"group {gi} tile shapes disagree with width {g.width}: "
                  f"dep_idx {g.dep_idx.shape}, dep_coef {g.dep_coef.shape}, "
                  f"dinv {g.dinv.shape}", check="shape", group=gi,
                  where=where)
        if not 0 < g.width <= sched.max_deps:
            _fail(f"group {gi} width {g.width} outside (0, max_deps="
                  f"{sched.max_deps}]", check="shape", group=gi, where=where)
        if g.width <= prev_w:
            _fail(f"group widths not strictly increasing at group {gi} "
                  f"({g.width} after {prev_w})", check="shape", group=gi,
                  where=where)
        prev_w = g.width
        if (g.carry_in is None) != (g.carry_out is None):
            _fail(f"group {gi} has only one of carry_in/carry_out",
                  check="shape", group=gi, where=where)
        if g.carry_in is not None and (g.carry_in.shape != (s, c) or
                                       g.carry_out.shape != (s, c)):
            _fail(f"group {gi} carry shapes {g.carry_in.shape}/"
                  f"{g.carry_out.shape} != {(s, c)}", check="shape",
                  group=gi, where=where)
        if g.n != sched.n:
            _fail(f"group {gi} n={g.n} != schedule n={sched.n}",
                  check="shape", group=gi, where=where)


def _check_bounds(sched, where):
    n, nc = sched.n, sched.n_carry
    for gi, g in enumerate(sched.groups):
        for name, arr, hi in (("row_ids", g.row_ids, n),
                              ("dep_idx", g.dep_idx, n)):
            bad = (arr < 0) | (arr > hi)
            if bad.any():
                st, ln = _first_bad(bad if arr.ndim == 2 else bad.any(2))
                _fail(f"{name} value {int(arr[bad][0])} outside [0, {hi}]",
                      check="index-bounds", step=st, lane=ln, group=gi,
                      where=where)
        if g.carry_in is not None:
            bad = (g.carry_in < 0) | (g.carry_in > nc)
            if bad.any():
                st, ln = _first_bad(bad)
                _fail(f"carry_in slot {int(g.carry_in[bad][0])} outside "
                      f"[0, {nc}]", check="index-bounds", step=st, lane=ln,
                      group=gi, where=where)
            bad = (g.carry_out < 0) | (g.carry_out > nc + 1) | \
                (g.carry_out == nc)
            if bad.any():
                st, ln = _first_bad(bad)
                _fail(f"carry_out slot {int(g.carry_out[bad][0])} outside "
                      f"[0, {nc}) u {{sink {nc + 1}}} (slot {nc} is the "
                      f"read-only zero slot)", check="index-bounds", step=st,
                      lane=ln, group=gi, where=where)


def _live_mask(sched, g):
    live = g.row_ids != sched.n
    if g.carry_out is not None:
        live = live | (g.carry_out != sched.n_carry + 1)
    return live


def _check_padding(sched, where):
    """Dead lanes are fully inert: no live coefficient, no dinv, and live
    coefficients never gather the zero slot (row n) — a live coef on an
    out-of-range row would read zero and silently corrupt the sum."""
    n = sched.n
    for gi, g in enumerate(sched.groups):
        live = _live_mask(sched, g)
        real = g.dep_coef != 0
        bad = real & ~live[:, :, None]
        if bad.any():
            st, ln = _first_bad(bad.any(2))
            _fail("nonzero dep_coef on a padding lane", check="padding",
                  step=st, lane=ln, group=gi, where=where)
        bad = real & (g.dep_idx == n)
        if bad.any():
            st, ln = _first_bad(bad.any(2))
            _fail("live coefficient gathers the zero slot (row n)",
                  check="padding", step=st, lane=ln, group=gi, where=where)
        bad = (g.row_ids == n) & (g.dinv != 0)
        if bad.any():
            st, ln = _first_bad(bad)
            _fail("nonzero dinv on a lane that finalizes no row",
                  check="padding", step=st, lane=ln, group=gi, where=where)


def _finalize_steps(sched, where):
    """fin_step[row] = step finalizing the row; enforces the bijection."""
    n = sched.n
    seen = np.zeros(n, dtype=np.int64)
    fin_step = np.full(n + 1, -1, dtype=np.int64)
    for gi, g in enumerate(sched.groups):
        fin = g.is_final
        rows = g.row_ids[fin]
        np.add.at(seen, rows, 1)
        steps = np.broadcast_to(
            np.arange(g.row_ids.shape[0])[:, None], g.row_ids.shape)[fin]
        fin_step[rows] = steps
    if (seen != 1).any():
        row = int(np.argwhere(seen != 1)[0][0])
        # locate the offending lane for the error message
        for gi, g in enumerate(sched.groups):
            hit = (g.row_ids == row) & g.is_final
            if hit.any():
                st, ln = _first_bad(hit)
                _fail(f"row {row} finalized {int(seen[row])} times (first "
                      f"duplicate lane shown)", check="bijection", step=st,
                      lane=ln, group=gi, where=where)
        _fail(f"row {row} finalized {int(seen[row])} times",
              check="bijection", where=where)
    return fin_step


def _check_races(sched, fin_step, where):
    """Every live dependency reads a row finalized at a STRICTLY earlier
    step — the scheduling-race invariant compaction must preserve."""
    for gi, g in enumerate(sched.groups):
        real = g.dep_coef != 0
        if not real.any():
            continue
        steps = np.arange(g.row_ids.shape[0])[:, None, None]
        prod = fin_step[g.dep_idx]          # -1 for never-finalized rows
        bad = real & (prod >= steps)
        if bad.any():
            st, ln = _first_bad(bad.any(2))
            dep = int(g.dep_idx[bad][0])
            _fail(f"dependency on row {dep} finalized at step "
                  f"{int(fin_step[dep])} (not strictly earlier) — "
                  f"scheduling race", check="race", step=st, lane=ln,
                  group=gi, where=where)


def _check_carry_order(sched, where):
    """Carry chains: every slot written exactly once, every read strictly
    after its write (split-row segments must land before the tail sums
    them)."""
    nc = sched.n_carry
    if nc <= 0:
        return
    writes = np.zeros(nc, dtype=np.int64)
    wstep = np.full(nc + 1, -1, dtype=np.int64)   # slot nc = zero slot
    for g in sched.groups:
        if g.carry_out is None:
            continue
        realw = g.carry_out != nc + 1
        slots = g.carry_out[realw]
        np.add.at(writes, slots, 1)
        steps = np.broadcast_to(
            np.arange(g.carry_out.shape[0])[:, None], g.carry_out.shape)
        wstep[slots] = steps[realw]
    # slot 0 may legitimately be unused on schedules without splits, but a
    # double write is always a lost segment
    if (writes > 1).any():
        slot = int(np.argwhere(writes > 1)[0][0])
        _fail(f"carry slot {slot} written {int(writes[slot])} times",
              check="carry-order", where=where)
    wstep[nc] = -1                                # zero slot: always ready
    for gi, g in enumerate(sched.groups):
        if g.carry_in is None:
            continue
        live = _live_mask(sched, g)
        used = live & (g.carry_in != nc)
        if not used.any():
            continue
        steps = np.arange(g.carry_in.shape[0])[:, None]
        ws = wstep[g.carry_in]
        bad = used & (ws < 0)
        if bad.any():
            st, ln = _first_bad(bad)
            _fail(f"carry slot {int(g.carry_in[bad][0])} read but never "
                  f"written", check="carry-order", step=st, lane=ln,
                  group=gi, where=where)
        bad = used & (ws >= steps)
        if bad.any():
            st, ln = _first_bad(bad)
            slot = int(g.carry_in[bad][0])
            _fail(f"carry slot {slot} read at or before its write step "
                  f"{int(wstep[slot])} — split-row race", check="carry-order",
                  step=st, lane=ln, group=gi, where=where)


def _check_dtypes(sched, where):
    dtype = np.dtype(sched.dtype)
    if dtype.kind != "f":
        _fail(f"schedule dtype {dtype} is not floating", check="dtype",
              where=where)
    for gi, g in enumerate(sched.groups):
        if g.dep_coef.dtype != dtype or g.dinv.dtype != dtype:
            _fail(f"group {gi} payload dtypes {g.dep_coef.dtype}/"
                  f"{g.dinv.dtype} != schedule dtype {dtype}", check="dtype",
                  group=gi, where=where)
        for name, arr in (("row_ids", g.row_ids), ("dep_idx", g.dep_idx),
                          ("carry_in", g.carry_in),
                          ("carry_out", g.carry_out)):
            if arr is not None and arr.dtype.kind not in "iu":
                _fail(f"group {gi} {name} dtype {arr.dtype} is not integer",
                      check="dtype", group=gi, where=where)


def _check_value_plan(sched, where):
    plan = sched.value_plan
    if plan is None:
        return
    n = sched.n
    lanes = sum(g.row_ids.size for g in sched.groups)
    slots = sum(g.dep_idx.size for g in sched.groups)
    if plan.ent_src is not None:
        if plan.ent_src.shape != (plan.nnz,):
            _fail(f"value-plan ent_src shape {plan.ent_src.shape} != "
                  f"({plan.nnz},)", check="value-plan", where=where)
        if plan.nnz and not ((plan.ent_src >= 0) &
                             (plan.ent_src < plan.nnz)).all():
            _fail("value-plan ent_src index outside [0, nnz)",
                  check="value-plan", where=where)
    if plan.coef_dst.shape != (plan.nnz,):
        _fail(f"value-plan coef_dst shape {plan.coef_dst.shape} != "
              f"({plan.nnz},)", check="value-plan", where=where)
    if plan.nnz and (np.unique(plan.coef_dst).size != plan.nnz or
                     not ((plan.coef_dst >= 0) &
                          (plan.coef_dst < slots)).all()):
        _fail("value-plan coef_dst is not an injection into the dep-slot "
              "buffer", check="value-plan", where=where)
    ln = plan.lane_slot.shape[0]
    if plan.lane_row.shape[0] != ln or plan.lane_final.shape[0] != ln:
        _fail("value-plan lane arrays disagree in length",
              check="value-plan", where=where)
    if ln and (np.unique(plan.lane_slot).size != ln or
               not ((plan.lane_slot >= 0) & (plan.lane_slot < lanes)).all()):
        _fail("value-plan lane_slot is not an injection into the lane "
              "buffer", check="value-plan", where=where)
    if ln and not ((plan.lane_row >= 0) & (plan.lane_row <= n)).all():
        _fail("value-plan lane_row outside [0, n]", check="value-plan",
              where=where)


def _check_values(sched, A, diag, where):
    """The value-level audit: packed-nnz accounting, payload finiteness,
    dinv bitwise equal to 1/diag in the schedule dtype."""
    packed = sum(int((g.dep_coef != 0).sum()) for g in sched.groups)
    if A is not None:
        # counted in the schedule dtype: an entry of A below its range
        # (lung2_like(1.0)'s avgLevelCost A' has 526 under 1e-45) is 0
        # there, as the schedule holds it, not lost (the reference counts
        # in float64 and rejects such a float32 schedule)
        want = int((np.asarray(A.data).astype(sched.dtype) != 0).sum())
        if packed != want:
            _fail(f"packed nnz {packed} != matrix nnz {want} — entries "
                  f"lost or duplicated", check="nnz", where=where)
    for gi, g in enumerate(sched.groups):
        bad = ~np.isfinite(g.dep_coef)
        if bad.any():
            st, ln = _first_bad(bad.any(2))
            _fail("non-finite dep_coef", check="finite", step=st, lane=ln,
                  group=gi, where=where)
        bad = ~np.isfinite(g.dinv)
        if bad.any():
            st, ln = _first_bad(bad)
            _fail("non-finite dinv", check="finite", step=st, lane=ln,
                  group=gi, where=where)
    if diag is not None:
        dtype = np.dtype(sched.dtype)
        dinv_of = np.zeros(sched.n + 1, dtype=dtype)
        if sched.n:
            dinv_of[:sched.n] = 1.0 / np.asarray(diag, dtype=dtype)
        for gi, g in enumerate(sched.groups):
            fin = g.is_final
            bad = fin & (g.dinv != dinv_of[g.row_ids])
            if bad.any():
                st, ln = _first_bad(bad)
                row = int(g.row_ids[bad][0])
                _fail(f"dinv disagrees with 1/diag[{row}] in {dtype}",
                      check="dinv", step=st, lane=ln, group=gi, where=where)
    return packed


def _lane_devices(g, devices: int) -> np.ndarray:
    """Device of each lane under the padded block sharding the sharded
    engine uses (lane axis padded to a multiple of `devices`, split in
    contiguous blocks)."""
    c = g.row_ids.shape[1]
    c_pad = -(-c // devices) * devices
    return np.minimum(np.arange(c) // (c_pad // devices), devices - 1)


def _critical_path_and_edges(sched, fin_step, devices: int):
    """One pass over steps: longest dependency chain through lanes and
    carry segments (in steps), and the cross-device dependency-edge count
    under block lane sharding over `devices` devices."""
    n, nc = sched.n, sched.n_carry
    depth = np.zeros(n + 1, dtype=np.int64)        # row n: zero slot
    cdepth = np.zeros(nc + 2, dtype=np.int64)
    dev_of_row = np.zeros(n + 1, dtype=np.int64)
    dev_of_carry = np.full(nc + 2, -1, dtype=np.int64)
    cross = 0
    lane_dev = [(_lane_devices(g, devices) if devices > 1 else None)
                for g in sched.groups]
    for s in range(sched.num_steps):
        updates = []
        for gi, g in enumerate(sched.groups):
            real = g.dep_coef[s] != 0                  # (C, D)
            dep_depth = np.where(real, depth[g.dep_idx[s]], 0).max(
                axis=1, initial=0)
            if g.carry_in is not None:
                dep_depth = np.maximum(dep_depth, cdepth[g.carry_in[s]])
            lane_depth = dep_depth + 1
            if devices > 1:
                dev = lane_dev[gi]
                prod = np.where(real, dev_of_row[g.dep_idx[s]],
                                dev[:, None])
                cross += int((real & (prod != dev[:, None])).sum())
                if g.carry_in is not None:
                    cprod = dev_of_carry[g.carry_in[s]]
                    cross += int(((cprod >= 0) & (cprod != dev)).sum())
            updates.append((g, lane_depth))
        for gi, (g, lane_depth) in enumerate(updates):
            fin = g.is_final[s]
            depth[g.row_ids[s][fin]] = lane_depth[fin]
            if devices > 1:
                dev_of_row[g.row_ids[s][fin]] = lane_dev[gi][fin]
            if g.carry_out is not None:
                w = g.carry_out[s] != nc + 1
                cdepth[g.carry_out[s][w]] = lane_depth[w]
                if devices > 1:
                    dev_of_carry[g.carry_out[s][w]] = lane_dev[gi][w]
    return int(depth[:n].max(initial=0)), cross


def verify_collectives(sched, mesh=None, axis: str = "model") -> int:
    """Certify one all_gather family per step of the sharded lowering
    (the sharded engine's synchronization invariant), counted by
    `solver.distributed.count_all_gathers` over `mesh`'s `axis` (None: a
    mesh of one rank).  Returns the family count."""
    from ..solver.distributed import count_all_gathers
    g = count_all_gathers(_host(sched), mesh=mesh, axis=axis)
    if g["families"] != g["steps"]:
        _fail(f"sharded lowering issued collectives in {g['families']} of "
              f"{g['steps']} steps — not one family per step ({g})",
              check="collectives", where="verify_collectives")
    return int(g["families"])


def verify_level_schedule(sched, A=None, diag=None, *, devices: int = 1,
                          collectives: bool = False, mesh=None,
                          mesh_axis: str = "model",
                          where: str = "verify_level_schedule"
                          ) -> ScheduleCertificate:
    """Statically verify a LevelSchedule/DeviceSchedule; return its
    certificate.

    A / diag:  the strict-lower matrix and diagonal the schedule was
               compiled from — enables the packed-nnz and dinv-agreement
               checks (structure-only verification runs without them).
    devices:   compute `cross_device_edges` for block lane sharding over
               this many devices (1 = single device, 0 edges).
    collectives: additionally certify one all_gather family per step of
               the sharded lowering over `mesh`'s `mesh_axis` (None: a
               mesh of one rank; off by default).
    Raises ScheduleInvariantError (a ResilienceError) on the first
    violation, naming the check, step, and lane.
    """
    sched = _host(sched)
    if devices < 1:
        raise ValueError(f"devices must be >= 1, got {devices}")
    checks = list(STRUCTURAL_CHECKS)
    if sched.num_steps == 0 or not sched.groups:
        if sched.n != 0:
            _fail(f"empty schedule for n={sched.n}", check="bijection",
                  where=where)
        return ScheduleCertificate(
            n=0, nnz=0, steps=0, levels=sched.num_levels, critical_path=0,
            cross_device_edges=0, devices=devices, n_carry=sched.n_carry,
            group_widths=(), flops=0, padded_flops=0,
            dtype=np.dtype(sched.dtype).name if sched.groups else "float32",
            collective_families=None, checks=tuple(checks))
    _check_shapes(sched, where)
    _check_bounds(sched, where)
    _check_padding(sched, where)
    fin_step = _finalize_steps(sched, where)
    _check_races(sched, fin_step, where)
    _check_carry_order(sched, where)
    _check_dtypes(sched, where)
    _check_value_plan(sched, where)
    checks += list(VALUE_CHECKS)
    packed = _check_values(sched, A, diag, where)
    crit, cross = _critical_path_and_edges(sched, fin_step, devices)
    fams = None
    if collectives:
        fams = verify_collectives(sched, mesh=mesh, axis=mesh_axis)
        checks.append("collectives")
    return ScheduleCertificate(
        n=sched.n, nnz=packed, steps=sched.num_steps,
        levels=sched.num_levels, critical_path=crit,
        cross_device_edges=cross, devices=devices, n_carry=sched.n_carry,
        group_widths=tuple(sched.group_widths), flops=sched.flops(),
        padded_flops=sched.padded_flops(),
        dtype=np.dtype(sched.dtype).name, collective_families=fams,
        checks=tuple(checks))


def verify_schedule_values(sched, A=None, diag=None, *,
                           where: str = "verify_schedule_values") -> int:
    """The value-only re-audit for pattern-frozen repacks: nnz accounting,
    finiteness, dinv agreement — O(nnz), no structural re-verification
    (the structure was certified when the pattern was built).  Returns the
    packed nnz; raises ScheduleInvariantError on violation."""
    return _check_values(_host(sched), A, diag, where)


def audit_transformed_system(ts, *, where: str = "audit_transformed_system"
                             ) -> dict:
    """Statically audit a TransformedSystem + its ReplayPlan commit log.

    Checks (docs/analysis.md): the rewritten dependency matrix is strictly
    lower triangular; both level assignments are monotone along every
    dependency edge (and recomputed never exceeds assigned); the fill
    accounting matches TransformMetrics (nnz_A, nnz_T, num_levels_after,
    rows_rewritten == committed rows); the T factor's references are
    source-monotone (every entity reads entities of strictly smaller
    source rows — what makes the preamble a triangular solve); the diagonal
    is finite and nonzero; replay-plan commits index in bounds and target
    strictly earlier levels, each row committed at most once.

    Returns {"rows": n, "commits": len(commits), ...} audit facts; raises
    TransformInvariantError on the first violation.
    """
    n = int(ts.diag.shape[0])
    d = np.asarray(ts.diag)
    if not np.isfinite(d).all() or (d == 0).any():
        raise TransformInvariantError(
            "diagonal contains zero or non-finite entries",
            check="diagonal", where=where)
    A = ts.A
    if A.n_rows != n:
        raise TransformInvariantError(
            f"A has {A.n_rows} rows, diagonal has {n}", check="shape",
            where=where)
    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    if A.nnz and not (A.indices < rows).all():
        p = int(np.argwhere(A.indices >= rows)[0][0])
        raise TransformInvariantError(
            f"entry ({int(rows[p])}, {int(A.indices[p])}) is not strictly "
            f"lower triangular", check="triangularity", where=where)
    for name, lof in (("assigned", ts.level_of_assigned),
                      ("recomputed", ts.level_of_recomputed)):
        if lof.shape[0] != n:
            raise TransformInvariantError(
                f"{name} level assignment has {lof.shape[0]} entries, "
                f"system has {n}", check="level-monotonicity", where=where)
        if A.nnz and not (lof[A.indices] < lof[rows]).all():
            bad = np.argwhere(lof[A.indices] >= lof[rows])[0][0]
            raise TransformInvariantError(
                f"{name} levels non-monotone along edge "
                f"({int(rows[bad])}, {int(A.indices[bad])})",
                check="level-monotonicity", where=where)
    if n and int(ts.level_of_recomputed.max()) > \
            int(ts.level_of_assigned.max()):
        raise TransformInvariantError(
            "recomputed level count exceeds assigned",
            check="level-monotonicity", where=where)
    m = ts.metrics
    if m.nnz_A != A.nnz or m.nnz_T != ts.T.nnz:
        raise TransformInvariantError(
            f"fill accounting drift: metrics say nnz_A={m.nnz_A}/"
            f"nnz_T={m.nnz_T}, system has {A.nnz}/{ts.T.nnz}",
            check="fill-accounting", where=where)
    want_levels = int(ts.level_of_assigned.max()) + 1 if n else 0
    if m.num_levels_after != want_levels:
        raise TransformInvariantError(
            f"metrics num_levels_after={m.num_levels_after}, assigned "
            f"levels={want_levels}", check="fill-accounting", where=where)
    T = ts.T
    if T.nnz:
        if ts.src.shape[0] != T.n_rows:
            raise TransformInvariantError(
                f"src maps {ts.src.shape[0]} entities, T has {T.n_rows}",
                check="t-factor", where=where)
        if not ((ts.src >= 0) & (ts.src < n)).all():
            raise TransformInvariantError(
                "entity source row outside [0, n)", check="t-factor",
                where=where)
        trows = np.repeat(np.arange(T.n_rows), np.diff(T.indptr))
        if not (ts.src[T.indices] < ts.src[trows]).all():
            raise TransformInvariantError(
                "T-factor reference is not source-monotone (an entity "
                "reads an entity of an equal or later source row) — the "
                "preamble would not be a triangular solve",
                check="t-factor", where=where)
    plan = ts.plan
    commits = 0
    if plan is not None:
        if plan.level_of0.shape[0] != n:
            raise TransformInvariantError(
                f"replay plan covers {plan.level_of0.shape[0]} rows, "
                f"system has {n}", check="replay-bounds", where=where)
        # re-commits are legal (EquationStore._commit_version): a strategy
        # may move the same row again, but only ever DOWNWARD — each
        # commit's target must be strictly below the row's current level
        cur = {}
        for k, (row, target) in enumerate(plan.commits):
            if not 0 <= row < n:
                raise TransformInvariantError(
                    f"commit {k} rewrites row {row} outside [0, {n})",
                    check="replay-bounds", where=where)
            level = cur.get(row, int(plan.level_of0[row]))
            if not 0 <= target < level:
                raise TransformInvariantError(
                    f"commit {k} moves row {row} to level {target}, not "
                    f"strictly earlier than its level {level}",
                    check="replay-bounds", where=where)
            cur[row] = target
        commits = len(plan.commits)
        if m.rows_rewritten != commits:
            raise TransformInvariantError(
                f"metrics count {m.rows_rewritten} rewritten rows, replay "
                f"plan commits {commits}", check="fill-accounting",
                where=where)
    return {"rows": n, "nnz_A": A.nnz, "nnz_T": T.nnz, "commits": commits,
            "levels_assigned": want_levels}


def verify_operator_payload(payload: dict, *, devices: int = 1,
                            collectives: bool = False, mesh=None,
                            mesh_axis: str = "model",
                            where: str = "verify_operator_payload"
                            ) -> ScheduleCertificate:
    """Verify one TriangularOperator payload end to end: audit the
    transformed system, then certify its schedule against ts.A/ts.diag
    (and with `collectives`, its sharded lowering over `mesh`'s
    `mesh_axis`, or a mesh of one rank).  The certificate is stashed under
    payload["certificate"], so cached artifacts carry their proof and are
    never re-verified."""
    ts = payload["ts"]
    audit_transformed_system(ts, where=where)
    cert = verify_level_schedule(payload["sched"], ts.A, ts.diag,
                                 devices=devices, collectives=collectives,
                                 mesh=mesh, mesh_axis=mesh_axis, where=where)
    payload["certificate"] = cert
    return cert


# -- what the card runs: the SpTRSV kernel's packed form ----------------------

#: checks verify_packed_schedule runs, in order (PackedCertificate.checks)
PACKED_CHECKS = ("shape", "index-bounds", "bijection", "race", "steps",
                 "long", "deps", "dinv", "value-map")
#: checks verify_packed_values runs after a device value refresh
PACKED_VALUE_CHECKS = ("value-map", "zero-set", "deps", "dinv")


@dataclasses.dataclass(frozen=True)
class PackedCertificate:
    """Summary of one verified packed form of a schedule (module doc).

    steps:      kernel steps, the free pass included (== packed.num_steps)
    tiles:      tiles of the stream
    lanes:      lanes of the free pass and the tiles (== rows)
    long_lanes: lanes summed by a warp (more than LONG_DEPS deps)
    far_pairs:  (index, coefficient) pairs held in `far`
    free_rows:  rows of the dependency-free pass
    checks:     names of the checks that ran
    """

    steps: int
    tiles: int
    lanes: int
    long_lanes: int
    far_pairs: int
    free_rows: int
    checks: tuple


def _packed_fail(msg, *, check, step=-1, lane=-1, where=""):
    raise ScheduleInvariantError(msg, check=check, step=step, lane=lane,
                                 where=where)


def _schedule_pairs(sched):
    """The schedule's rows as the kernel must solve them: per live lane its
    final row (a carry chain's partial lanes belong to the row their chain
    ends in), and the (row, index, float32 coefficient bits) of every dep
    slot that is non-zero in the schedule dtype; plus 1/diag per row as
    float32 bits.  Returns (pair_row, pair_idx, pair_coef_bits, dinv_bits,
    slots) or raises on a carry chain that does not end in a row.  `slots`
    places the pairs in the schedule's flat value buffer
    (`kernels.sptrsv_level.schedule_values`): "pair" the slot of each
    pair, "zero" the slots of the live lanes' zero coefficients,
    "dinv_row" per 1/diag slot the row it finalizes (-1: none), and
    "coef_slots".  It walks the chains itself rather than through the
    packer's `_fuse_chains`, so that a fault of the packer cannot certify
    its own output."""
    n, nc = sched.n, sched.n_carry
    row, cin, cout, deps, pslot, zslot, drow = [], [], [], [], [], [], []
    dinv_bits = np.zeros(n, dtype=np.int32)
    off_c = 0
    for g in sched.groups:
        live = _live_mask(sched, g)
        s_i, c_i = np.nonzero(live)
        row.append(g.row_ids[s_i, c_i].astype(np.int64))
        if g.carry_in is not None:
            cin.append(g.carry_in[s_i, c_i].astype(np.int64))
            cout.append(g.carry_out[s_i, c_i].astype(np.int64))
        else:
            cin.append(np.full(s_i.size, nc, dtype=np.int64))
            cout.append(np.full(s_i.size, nc + 1, dtype=np.int64))
        coef = g.dep_coef[s_i, c_i]
        keep = coef != 0
        deps.append((np.nonzero(keep)[0], g.dep_idx[s_i, c_i][keep],
                     coef[keep].astype(np.float32).view(np.int32), s_i.size))
        C, D = g.dep_coef.shape[1], g.dep_coef.shape[2]
        slot = off_c + (s_i.astype(np.int64) * C + c_i)[:, None] * D + \
            np.arange(D)
        pslot.append(slot[keep])
        zslot.append(slot[~keep])
        off_c += g.dep_coef.size
        fin = g.is_final
        drow.append(np.where(fin, g.row_ids, -1).astype(np.int64).ravel())
        dinv_bits[g.row_ids[fin]] = \
            g.dinv[fin].astype(np.float32).view(np.int32)
    row, cin, cout = (np.concatenate(a) if a else np.zeros(0, np.int64)
                      for a in (row, cin, cout))
    # each lane's successor: the reader of the carry slot it writes
    nxt = np.arange(row.size, dtype=np.int64)
    writes = cout != nc + 1
    if writes.any():
        reader = np.full(nc + 1, -1, dtype=np.int64)
        reads = cin != nc
        reader[cin[reads]] = np.flatnonzero(reads)
        nxt[writes] = reader[cout[writes]]
        if (nxt[writes] < 0).any():
            slot = int(cout[writes][nxt[writes] < 0][0])
            _packed_fail(f"carry slot {slot} is written but no lane reads "
                         "it: its chain ends in no row", check="deps")
        while True:                                  # pointer jumping
            jumped = nxt[nxt]
            if np.array_equal(jumped, nxt):
                break
            nxt = jumped
    final_row = row[nxt]
    pr, pi, pc = [], [], []
    base = 0
    for lane_of, idx, bits, nlanes in deps:
        pr.append(final_row[base + lane_of])
        pi.append(idx.astype(np.int64))
        pc.append(bits)
        base += nlanes
    cat = [np.concatenate(a) if a else np.zeros(0, dt)
           for a, dt in ((pr, np.int64), (pi, np.int64), (pc, np.int32),
                         (pslot, np.int64), (zslot, np.int64),
                         (drow, np.int64))]
    slots = {"pair": cat[3], "zero": cat[4], "dinv_row": cat[5],
             "coef_slots": off_c}
    return cat[0], cat[1], cat[2], dinv_bits, slots


def _decode_records(packed, where):
    """Check the tile stream's pointers, headers and every offset a lane
    record follows, vectorised over tiles and lanes, so that decoding it
    (`unpack_tiles`) cannot read outside `tiles` or `far`.  Returns per
    record its tile, its position in the tile, its dep count and whether
    its pairs lie in `far`, its record's word in `tiles` and its first
    pair's word in `tiles` followed by `far`, and per tile its lanes, long
    lanes and flags: (tile, pos, lanes, long, flags, cnt, far, rec,
    pair)."""
    from ..kernels import sptrsv_level as K
    w = K._np(packed.tiles).astype(np.int64)
    tp = K._np(packed.tile_ptr).astype(np.int64)
    nfar = int(K._np(packed.far).size)
    if w.size % 4 or tp.size < 1 or tp[0] != 0 or \
            (np.diff(tp) <= 0).any() or 4 * tp[-1] != w.size:
        _packed_fail(f"tile_ptr ({tp.size} entries, ends at "
                     f"{int(tp[-1]) if tp.size else None}) does not start "
                     f"at 0, rise, and end at len(tiles) / 4 = "
                     f"{w.size / 4}", check="shape", where=where)
    if nfar % 2:
        _packed_fail(f"far holds {nfar} words, not (index, coefficient) "
                     "pairs", check="shape", where=where)
    T = tp.size - 1
    tw = 4 * np.diff(tp)                         # words per tile
    if T and (4 * tw > packed.stage_bytes).any():
        t = int(np.flatnonzero(4 * tw > packed.stage_bytes)[0])
        _packed_fail(f"tile {t} holds {4 * int(tw[t])} bytes, more than a "
                     f"ring stage's {packed.stage_bytes}", check="shape",
                     where=where)
    if T and not (1 <= packed.num_stages <= K.MAX_STAGES and
                  packed.num_stages * packed.stage_bytes <= K.RING_BYTES):
        _packed_fail(f"{packed.num_stages} stages of {packed.stage_bytes} "
                     f"bytes do not fit the kernel's ring", check="shape",
                     where=where)
    hdr = 4 * tp[:-1]
    nl, nlong, flags, pad = (w[hdr + k] for k in range(4))
    bad = (nl < 1) | (nlong < 0) | (nlong > nl) | (flags & ~3 != 0) | \
        (pad != 0) | (K.HEADER_WORDS + K.LANE_WORDS * nl > tw)
    bad |= ((flags & 2) != 0) & ((flags & 1) == 0)   # a run ends its steps
    if bad.any():
        t = int(np.flatnonzero(bad)[0])
        _packed_fail(f"tile {t} header (lanes {int(nl[t])}, long "
                     f"{int(nlong[t])}, flags {int(flags[t])}) is "
                     f"inconsistent with its {int(tw[t])} words",
                     check="shape", where=where)
    tile = np.repeat(np.arange(T), nl)
    pos = K._segment_arange(nl)
    rec = hdr[tile] + K.HEADER_WORDS + K.LANE_WORDS * pos
    cnt = w[rec + 3] & 0x7FFFFFFF
    off = w[rec + 2]
    far = off < 0
    p = np.where(far, ~off, 0)
    in_tile = ~far & ((off % 2 != 0) |
                      (off < K.HEADER_WORDS + K.LANE_WORDS * nl[tile]) |
                      (off + 2 * cnt > tw[tile]))
    in_far = far & (p + cnt > nfar // 2)
    if (in_tile | in_far).any():
        k = int(np.flatnonzero(in_tile | in_far)[0])
        what = "far" if far[k] else f"tile {int(tile[k])}"
        _packed_fail(f"lane {int(pos[k])} of tile {int(tile[k])}: its "
                     f"{int(cnt[k])} deps at offset {int(off[k])} lie "
                     f"outside {what}", check="index-bounds", where=where)
    pair = np.where(far, w.size + 2 * p, hdr[tile] + off)
    return tile, pos, nl, nlong, flags, cnt, far, rec, pair


def verify_packed_schedule(packed, sched, *,
                           where: str = "verify_packed_schedule"
                           ) -> PackedCertificate:
    """Statically verify the SpTRSV kernel's packed form of `sched` (a
    LevelSchedule or DeviceSchedule, itself certified by
    `verify_level_schedule`); return its `PackedCertificate`.

    Checks, in order (PACKED_CHECKS; module doc): shape, index-bounds,
    bijection (the free pass and the tiles finalize every row exactly
    once), race (every dep of a lane is finalized at a strictly earlier
    decoded step; the free pass is step 0, the tiles' steps end at the
    lanes flagged last), steps (== packed.num_steps), long (a lane is long
    exactly when it has more than LONG_DEPS deps, long lanes first in
    their tile, none in a narrow run), deps and dinv (per row, against
    the schedule's non-zero pairs with carry chains fused and its 1/diag,
    bitwise in float32), value-map (`_check_value_map`: the map that
    `refresh_packed_values` writes through names the stream's value words,
    each once, from the slots that hold their values).  Raises ScheduleInvariantError on the first
    violation, naming the check and, where it can, the step and the lane
    (its position among its step's lanes in stream order).
    """
    from ..kernels import sptrsv_level as K
    sched = _host(sched)
    n = sched.n
    if packed.n != n or packed.n_carry != sched.n_carry:
        _packed_fail(f"packed form is for n={packed.n}, n_carry="
                     f"{packed.n_carry}; the schedule has n={n}, n_carry="
                     f"{sched.n_carry}", check="shape", where=where)
    free_row = K._np(packed.free_row).astype(np.int64)
    free_dinv = np.asarray(K._np(packed.free_dinv), dtype=np.float32)
    if free_dinv.shape != free_row.shape:
        _packed_fail(f"{free_row.size} free rows but {free_dinv.size} free "
                     "1/diag", check="shape", where=where)
    tile, pos, nl, nlong, flags, cnt, far, rec, pair = \
        _decode_records(packed, where)
    lanes = K.unpack_tiles(packed)
    last = lanes["last"]
    # flags against the lanes' last bits: a wide tile holds one step (or
    # part of one) and its last lane ends the step iff the tile does; a
    # narrow run ends at its last lane with each of its steps at most
    # NARROW_LANES lanes.  Then the decoded steps are the kernel's.
    T = nl.size
    ends = np.cumsum(nl) - 1
    run = (flags & 2) != 0
    tile_last = last[ends] if T else np.zeros(0, bool)
    lasts_in = np.bincount(tile, weights=last, minlength=T)
    bad = (~run & ((lasts_in != tile_last) |
                   (tile_last != ((flags & 1) != 0)))) | (run & ~tile_last)
    if bad.any():
        t = int(np.flatnonzero(bad)[0])
        _packed_fail(f"tile {t} (flags {int(flags[t])}) marks "
                     f"{int(lasts_in[t])} lanes as ending a step, which "
                     "its flags do not allow", check="shape", where=where)
    step = lanes["step"].astype(np.int64)
    first = np.concatenate([[True], step[1:] != step[:-1]]) if step.size \
        else np.zeros(0, bool)
    lane_in_step = np.arange(step.size) - \
        np.maximum.accumulate(np.where(first, np.arange(step.size), 0))
    if run.any():
        in_run = run[tile]
        width = np.bincount(step[in_run], minlength=int(step.max()) + 1)
        wide = np.flatnonzero(width > K.NARROW_LANES)
        if wide.size:
            _packed_fail(f"a narrow run holds a step of {int(width[wide[0]])}"
                         f" lanes, more than {K.NARROW_LANES}",
                         check="shape", step=int(wide[0]), where=where)
    if packed.num_lanes != n or packed.num_deps != int(cnt.sum()) or \
            packed.long_lanes != int(np.count_nonzero(cnt > K.LONG_DEPS)):
        _packed_fail(f"packed metadata (lanes {packed.num_lanes}, deps "
                     f"{packed.num_deps}, long {packed.long_lanes}) "
                     f"disagrees with its stream (rows {n}, deps "
                     f"{int(cnt.sum())})", check="shape", where=where)

    def at(k, msg, check):
        _packed_fail(f"{msg} (tile {int(tile[k])})", check=check,
                     step=int(step[k]), lane=int(lane_in_step[k]),
                     where=where)

    # index-bounds
    row = lanes["row"].astype(np.int64)
    dep_idx = lanes["dep_idx"].astype(np.int64)
    owner = np.repeat(np.arange(row.size), cnt)
    bad = (row < 0) | (row >= n)
    if bad.any():
        k = int(np.flatnonzero(bad)[0])
        at(k, f"row {int(row[k])} outside [0, {n})", "index-bounds")
    bad = (dep_idx < 0) | (dep_idx >= n)
    if bad.any():
        k = int(owner[np.flatnonzero(bad)[0]])
        at(k, f"dep index {int(dep_idx[bad][0])} outside [0, {n})",
           "index-bounds")
    bad = (free_row < 0) | (free_row >= n)
    if bad.any():
        _packed_fail(f"free row {int(free_row[bad][0])} outside [0, {n})",
                     check="index-bounds", step=0,
                     lane=int(np.flatnonzero(bad)[0]), where=where)
    # bijection
    seen = np.bincount(np.concatenate([free_row, row]), minlength=n)
    if (seen != 1).any():
        r = int(np.flatnonzero(seen != 1)[0])
        hit = np.flatnonzero(row == r)
        if hit.size > 1:
            at(int(hit[1]), f"row {r} finalized {int(seen[r])} times",
               "bijection")
        _packed_fail(f"row {r} finalized {int(seen[r])} times",
                     check="bijection", step=0 if r in free_row else -1,
                     where=where)
    # race
    fin_step = np.zeros(n, dtype=np.int64)
    fin_step[row] = step
    bad = fin_step[dep_idx] >= step[owner]
    if bad.any():
        j = int(np.flatnonzero(bad)[0])
        dep = int(dep_idx[j])
        at(int(owner[j]), f"dependency on row {dep} finalized at step "
           f"{int(fin_step[dep])} (not strictly earlier) — scheduling race",
           "race")
    # steps
    got = int(bool(free_row.size)) + int(last.sum())
    if got != packed.num_steps:
        _packed_fail(f"the stream decodes to {got} steps, the packed form "
                     f"says {packed.num_steps}", check="steps", where=where)
    # long
    is_long = pos < nlong[tile]
    bad = (is_long != (cnt > K.LONG_DEPS)) | (far != (cnt > K.FAR_DEPS)) | \
        (is_long & run[tile])
    if bad.any():
        k = int(np.flatnonzero(bad)[0])
        at(k, f"lane of {int(cnt[k])} deps at position {int(pos[k])} of a "
           f"tile with {int(nlong[tile[k]])} long lanes (long: more than "
           f"{K.LONG_DEPS} deps, first in the tile, none in a narrow run; "
           f"in far: more than {K.FAR_DEPS})", "long")
    # deps: per row, the schedule's non-zero pairs, chains fused.  A row
    # reads a column once, so the (row, index) keys are unique on a right
    # side and one sort by key lines the two sides up
    p_row, p_idx, p_bits, d_bits, slots = _schedule_pairs(sched)
    p_key = p_row * n + p_idx
    k_key = row[owner] * n + dep_idx
    k_bits = lanes["dep_coef"].view(np.int32)
    want = np.argsort(p_key, kind="stable")
    have = np.argsort(k_key, kind="stable")
    p_key, p_bits, k_key, k_bits = (p_key[want], p_bits[want],
                                    k_key[have], k_bits[have])
    if p_key.size != k_key.size or not (np.array_equal(p_key, k_key) and
                                        np.array_equal(p_bits, k_bits)):
        m = min(p_key.size, k_key.size)
        diff = np.flatnonzero((p_key[:m] != k_key[:m]) |
                              (p_bits[:m] != k_bits[:m]))
        j = int(diff[0]) if diff.size else m
        key = int(k_key[j] if j < k_key.size else p_key[j])
        r = key // n if n else 0
        msg = (f"row {r} holds (index, coefficient bits) "
               + (f"({int(k_key[j]) % n}, {int(k_bits[j])})"
                  if j < k_key.size else "nothing more")
               + " where the schedule's fused row holds "
               + (f"({int(p_key[j]) % n}, {int(p_bits[j])})"
                  if j < p_key.size else "nothing more"))
        hit = np.flatnonzero(row == r)
        if hit.size:
            at(int(hit[0]), msg, "deps")
        _packed_fail(msg, check="deps", step=0, where=where)
    # dinv
    k_dinv = lanes["dinv"].view(np.int32)
    bad = k_dinv != d_bits[row]
    if bad.any():
        k = int(np.flatnonzero(bad)[0])
        at(k, f"1/diag of row {int(row[k])} differs from the schedule's "
           "in float32", "dinv")
    bad = free_dinv.view(np.int32) != d_bits[free_row]
    if bad.any():
        k = int(np.flatnonzero(bad)[0])
        _packed_fail(f"free-pass 1/diag of row {int(free_row[k])} differs "
                     "from the schedule's in float32", check="dinv", step=0,
                     lane=k, where=where)
    # value-map: the map a device refresh writes through
    _check_value_map(packed, slots, p_row * n + p_idx,
                     row[owner] * n + dep_idx,
                     pair[owner] + 2 * K._segment_arange(cnt) + 1,
                     row, rec + 1, free_row, where)
    return PackedCertificate(
        steps=packed.num_steps, tiles=T, lanes=int(row.size + free_row.size),
        long_lanes=int(np.count_nonzero(cnt > K.LONG_DEPS)),
        far_pairs=int(K._np(packed.far).size // 2),
        free_rows=int(free_row.size), checks=PACKED_CHECKS)


def _check_value_map(packed, slots, pair_key, dep_key, dep_word, row,
                     dinv_word, free_row, where):
    """Certify `packed.values`, the `ValueMap` that `refresh_packed_values`
    scatters new values through, against the decoded stream.  Its words
    are the stream's coefficient words and tile 1/diag words, each exactly
    once. The source slot of each word holds that word's pair (row, index)
    or its row's 1/diag. `free_src` holds the free rows' 1/diag. `kept` and
    `dropped` are the live lanes' non-zero and zero coefficient slots.
    pair_key (row * n + index) per schedule pair (slots["pair"] order);
    per decoded dep its key and coefficient word (in `tiles`, then `far`);
    per tile lane its row and 1/diag word."""
    vm = packed.values
    if vm is None:
        return
    cs, d_row = slots["coef_slots"], slots["dinv_row"]

    def fail(msg):
        _packed_fail(msg, check="value-map", where=where)

    if vm.coef_slots != cs or vm.dinv_slots != d_row.size:
        fail(f"the value map is for {vm.coef_slots} + {vm.dinv_slots} value "
             f"slots, the schedule has {cs} + {d_row.size}")
    n_slots = cs + d_row.size
    # what each slot holds: a pair's key, a finalized row's 1/diag, or -1
    held = np.full(n_slots, -1, dtype=np.int64)
    held[slots["pair"]] = pair_key
    held[cs:] = d_row
    nw = int(packed.tiles.numel())
    in_tile = dep_word < nw
    for what, words, srcs, size, w_at, w_held, w_dinv in (
            ("tiles", vm.tile_word, vm.tile_src, nw,
             np.concatenate([dep_word[in_tile], dinv_word]),
             np.concatenate([dep_key[in_tile], row]),
             np.repeat([False, True], [int(in_tile.sum()), row.size])),
            ("far", vm.far_word, vm.far_src, int(packed.far.numel()),
             dep_word[~in_tile] - nw, dep_key[~in_tile],
             np.zeros(int((~in_tile).sum()), bool))):
        key = np.full(size, -1, dtype=np.int64)
        is_dinv = np.zeros(size, bool)
        key[w_at], is_dinv[w_at] = w_held, w_dinv
        words, srcs = np.asarray(words), np.asarray(srcs)
        ok = words.shape == srcs.shape and words.size == w_at.size and \
            ((words >= 0) & (words < size)).all() and \
            np.unique(words).size == words.size
        if not ok:
            fail(f"the value map's {words.size} words in {what} are not its "
                 f"{w_at.size} value words, each once")
        bad = (key[words] < 0) | (srcs < 0) | (srcs >= n_slots)
        bad |= np.where(is_dinv[words], srcs < cs, srcs >= cs)
        bad |= held[np.clip(srcs, 0, n_slots - 1)] != key[words]
        if bad.any():
            k = int(np.flatnonzero(bad)[0])
            fail(f"the value map writes {what} word {int(words[k])} from "
                 f"value slot {int(srcs[k])}, which is not the value it "
                 "holds")
    coef_src = np.concatenate([vm.tile_src[vm.tile_src < cs], vm.far_src])
    if np.unique(coef_src).size != coef_src.size or \
            coef_src.size != slots["pair"].size:
        fail(f"the value map writes {coef_src.size} coefficients from "
             f"{np.unique(coef_src).size} slots; the schedule keeps "
             f"{slots['pair'].size}")
    fs = np.asarray(vm.free_src)
    if fs.shape != free_row.shape or ((fs < cs) | (fs >= n_slots)).any() or \
            (d_row[np.clip(fs - cs, 0, d_row.size - 1)] != free_row).any():
        fail("the value map's free_src is not the free rows' 1/diag")
    for name, got, want in (("kept", vm.kept, slots["pair"]),
                            ("dropped", vm.dropped, slots["zero"])):
        if not np.array_equal(np.sort(got), np.sort(want)):
            fail(f"the value map's {name} slots ({np.size(got)}) are not "
                 f"the live lanes' {'non-zero' if name == 'kept' else 'zero'}"
                 f" coefficients ({want.size})")


def verify_packed_values(packed, sched, *,
                         where: str = "verify_packed_values"
                         ) -> PackedCertificate:
    """Verify a device value refresh (`refresh_packed_values`) of a packed
    form whose structure was certified: the words the refresh rewrote
    (every kept coefficient and 1/diag in the tiles and `far`, and
    `free_dinv`), read back through the pack's `ValueMap` with one gather
    on the packed form's device and one copy to the host, equal the
    schedule's float32 values bitwise, and the schedule's zero set is the
    one the packing dropped.  O(nnz).  Returns a `PackedCertificate`
    whose checks are PACKED_VALUE_CHECKS; raises ScheduleInvariantError.
    """
    import torch
    from ..kernels import sptrsv_level as K
    sched = _host(sched)
    vm = packed.values
    vals = K.schedule_values(sched)
    if vm is None or vals.size != vm.coef_slots + vm.dinv_slots:
        _packed_fail("the packed form carries no value map for this "
                     "schedule's value slots", check="value-map",
                     where=where)
    coef = vals[:vm.coef_slots]
    if (coef[vm.kept] == 0).any() or (coef[vm.dropped] != 0).any():
        _packed_fail("the schedule's zero set is not the one the packing "
                     "dropped: its form must be packed anew",
                     check="zero-set", where=where)
    tile_word, _, far_word, _, _ = vm.staged(packed.tiles.device)
    got = torch.cat([packed.tiles.view(torch.float32)[tile_word],
                     packed.far.view(torch.float32)[far_word],
                     packed.free_dinv.to(torch.float32)]).cpu().numpy()
    want = np.concatenate([vals[vm.tile_src], vals[vm.far_src],
                           vals[vm.free_src]]).astype(np.float32)
    bad = got.view(np.int32) != want.view(np.int32)
    if bad.any():
        k = int(np.flatnonzero(bad)[0])
        src = int(np.concatenate([vm.tile_src, vm.far_src, vm.free_src])[k])
        is_dinv = src >= vm.coef_slots
        _packed_fail(f"refreshed word {k} holds {float(got[k])!r}, the "
                     f"schedule's value slot {src} is {float(want[k])!r}",
                     check="dinv" if is_dinv else "deps", where=where)
    return PackedCertificate(
        steps=packed.num_steps, tiles=packed.num_tiles,
        lanes=packed.num_lanes, long_lanes=packed.long_lanes,
        far_pairs=int(packed.far.numel() // 2), free_rows=packed.num_free,
        checks=PACKED_VALUE_CHECKS)
