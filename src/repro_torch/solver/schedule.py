"""Schedule compiler: (transformed) triangular system -> bucketed ELL schedule.

DESIGN — the schedule-compiler pipeline
=======================================
(How this layer fits the transform -> compile -> engines -> operator stack
is documented in docs/architecture.md.)

The paper's testbed compiles a matrix into specialized C code; our TPU-native
analogue compiles it into a *static ELL schedule*: a sequence of fixed-shape
steps executed in order, with all cross-step dependencies resolved at compile
(build) time.  The compiler runs four vectorized passes — no per-row or
per-lane Python loops anywhere on the hot path:

1. **Lane construction** (`_build_lanes`).  Rows are ordered by (level, id)
   and expanded into *lanes*.  A row with nnz <= max_deps is one lane; a
   fatter row is split into ceil(nnz / max_deps) partial-row lanes that chain
   through a *carry slot*: leading segments accumulate partial dot products
   into the slot, the final segment adds the carry, subtracts from c and
   divides by the diagonal.  Lane dep lists are contiguous slices of the CSR
   arrays re-gathered into lane order, so all later passes address them with
   (ptr, width) pairs.  Carry-slot ids are assigned with one cumsum.

2. **Step assignment**.  Two modes:
   * *level-aligned* (`compact=False`) — the classic layout: each level
     becomes its own run of steps (split segments in distinct sub-steps,
     chunks of `chunk` lanes).  Fully vectorized with bincount/cumsum
     arithmetic; reproduces the legacy step structure bit-for-bit.
   * *dependency-aware compaction* (`compact=True`, the default) — a greedy
     list scheduler.  Each lane's earliest step is 1 + max(step of the rows
     it reads); lanes are packed into the earliest step with free capacity
     (`chunk` lanes/step), so under-full steps absorb rows from later
     levels and leading segments of split rows start as soon as *their own*
     dependencies allow — `num_steps` drops to the dependency-critical path
     instead of the level count.  The invariant "no lane reads a row
     finalized in the same step" is what makes intra-step execution order
     free (engines and the Pallas kernel exploit this).  When the level
     assignment is *tight* (level == 1 + max dep level, true for recomputed
     level sets), runs of regular levels are batch-assigned in one shot;
     only oversized (> chunk lanes) or split-row levels take the slow path.

3. **Width bucketing** (`_materialize`).  Lanes of one step are grouped into
   dependency-width classes D in `widths` (clipped to the widest real lane),
   and the schedule is materialized as one `WidthGroup` per class: arrays of
   shape (S, C_g) / (S, C_g, D_g) where C_g is the max class population over
   steps, rounded to the 8-sublane TPU tile.  Thin rows no longer pay for a
   global max_deps ELL pad — `padded_flops()` and HBM bytes scale with the
   per-class widths actually present.

4. **Tile fill**.  All ELL tiles are scattered array-at-a-time: one flat
   index expression per group fills dep_idx/dep_coef for every lane at once.

Execution model: engines run groups of a step in any (sequential) order,
then advance to the next step; `x` and the carry vector are the only state
carried across steps.  Padding lanes write the garbage slots (`n` for x,
`n_carry+1` for carries), so no masking is needed anywhere.

Copy of `repro.solver.schedule` (numpy host half);
tests/test_torch_host_copy.py holds the two equal.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..sparse.csr import CSR
from ..sparse.levels import LevelSets

__all__ = ["WidthGroup", "LevelSchedule", "SchedValuePlan", "build_schedule",
           "schedule_for_csr", "schedule_for_transformed",
           "schedule_for_preamble", "repack_schedule_values",
           "validate_schedule", "DEFAULT_WIDTHS"]

DEFAULT_WIDTHS = (4, 8, 16, 32)


@dataclasses.dataclass(frozen=True)
class WidthGroup:
    """One dependency-width class of the schedule, stacked over all steps.

    All arrays have leading dim S (number of steps); C_g lanes per step.
      row_ids:  (S, C) int32   output row per lane; n => padding/partial lane
      dep_idx:  (S, C, D) int32 gather indices into x; padding slots hold 0
                 and are inert because their dep_coef is 0
      dep_coef: (S, C, D) float
      dinv:     (S, C) float    1/diag (0 for padding/partial lanes)
      carry_in: (S, C) int32    carry slot to add (n_carry => zero slot);
                 None when the group holds no partial-row lanes — engines
                 then skip the carry machinery entirely
      carry_out:(S, C) int32    carry slot to write (n_carry+1 => sink);
                 None together with carry_in
    A lane finalizes its row iff row_ids != n (partial lanes park at the
    padding slot), and row_ids doubles as the c gather index.
    """

    width: int
    n: int
    row_ids: np.ndarray
    dep_idx: np.ndarray
    dep_coef: np.ndarray
    dinv: np.ndarray
    carry_in: np.ndarray | None = None
    carry_out: np.ndarray | None = None

    @property
    def is_final(self) -> np.ndarray:
        """Derived, not materialized: only final lanes carry a real row id."""
        return self.row_ids != self.n

    @property
    def c_ids(self) -> np.ndarray:
        """c gather indices coincide with row_ids (padding lanes hit the
        zero slot either way) — kept as an alias, not materialized."""
        return self.row_ids

    @property
    def lanes(self) -> int:
        return int(self.row_ids.shape[1])


@dataclasses.dataclass(frozen=True)
class SchedValuePlan:
    """Value-scatter map recorded at materialization time (pattern-only).

    The lane/tile layout is a pure function of the sparsity pattern and the
    level assignment, but the mapping "matrix entry k -> ELL tile slot" is
    unrecoverable from the materialized tiles (split-row partial lanes park
    at the padding row).  Recording it lets `repack_schedule_values` refill
    `dep_coef`/`dinv` for new values on the frozen pattern without re-running
    lane construction, step assignment, or bucketing.

    nnz:        expected length of the value vector.
    ent_src:    gather from data order into packed-entry (lane) order;
                None when they coincide.
    coef_dst:   flat scatter positions into the concatenated dep-slot buffer,
                one per packed entry, in lane-entry order.
    lane_slot:  flat positions into the concatenated lane-scalar buffer,
                one per lane, in (group, step)-sorted lane order.
    lane_row:   output row per sorted lane.
    lane_final: which sorted lanes finalize their row (partial-row lanes
                get dinv 0, like the original fill).
    """

    nnz: int
    ent_src: np.ndarray | None
    coef_dst: np.ndarray
    lane_slot: np.ndarray
    lane_row: np.ndarray
    lane_final: np.ndarray


@dataclasses.dataclass(frozen=True)
class LevelSchedule:
    """Compiled ELL schedule: a tuple of WidthGroups sharing the step axis.

    groups:   one WidthGroup per dependency-width class, ordered by width.
    n:        system size; n_carry: number of carry slots (>= 1).
    num_levels: level count of the *input* level assignment (compaction may
      use fewer steps when the assignment skips levels).
    chunk / max_deps: the configured capacity caps (C_g <= chunk per class,
      D_g <= max_deps).
    compacted: whether dependency-aware step compaction ran.
    build_ms: wall-clock schedule-compile time.
    value_plan: entry->tile scatter map for pattern-frozen value repacks
      (`repack_schedule_values`); None only for schedules constructed by
      hand without `build_schedule`.
    """

    groups: tuple
    n: int
    n_carry: int
    num_levels: int
    chunk: int
    max_deps: int
    compacted: bool
    build_ms: float
    value_plan: SchedValuePlan | None = None

    @property
    def num_steps(self) -> int:
        return int(self.groups[0].row_ids.shape[0]) if self.groups else 0

    @property
    def num_groups(self) -> int:
        return len(self.groups)

    @property
    def group_widths(self) -> tuple:
        return tuple(g.width for g in self.groups)

    @property
    def dtype(self):
        return self.groups[0].dep_coef.dtype

    @property
    def dep_coef(self):
        """Widest group's coefficients (dtype/back-compat accessor)."""
        return self.groups[-1].dep_coef

    def memory_bytes(self) -> int:
        return sum(a.nbytes for g in self.groups for a in (
            g.row_ids, g.dep_idx, g.dep_coef, g.dinv, g.carry_in,
            g.carry_out) if a is not None)

    def flops(self) -> int:
        """Real FLOPs executed (2 per dep + 1 div per final lane)."""
        return int(sum(2 * (g.dep_coef != 0).sum() + g.is_final.sum()
                       for g in self.groups))

    def padded_flops(self) -> int:
        """FLOPs including padding lanes — what the hardware actually does."""
        tot = 0
        for g in self.groups:
            s, c, d = g.dep_idx.shape
            tot += 2 * s * c * d + s * c
        return int(tot)

    def lanes_per_step(self) -> np.ndarray:
        """Real (non-padding) lanes per step, summed over groups."""
        out = np.zeros(self.num_steps, dtype=np.int64)
        for g in self.groups:
            live = g.is_final
            if g.carry_out is not None:
                live = live | (g.carry_out != self.n_carry + 1)
            out += live.sum(1)
        return out


# -- small vector helpers -----------------------------------------------------

def _segment_arange(seg_lens: np.ndarray) -> np.ndarray:
    """[0..l0-1, 0..l1-1, ...] for segment lengths (vectorized)."""
    total = int(seg_lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    ends = np.cumsum(seg_lens)
    starts = ends - seg_lens
    return np.arange(total, dtype=np.int64) - np.repeat(starts, seg_lens)


def _segment_max(vals: np.ndarray, ptr: np.ndarray, empty: int) -> np.ndarray:
    """Per-segment max of vals over slices ptr[i]:ptr[i+1]; `empty` for
    zero-width segments."""
    nseg = len(ptr) - 1
    out = np.full(nseg, empty, dtype=np.int64)
    widths = np.diff(ptr)
    nz = np.flatnonzero(widths > 0)
    if nz.size:
        out[nz] = np.maximum.reduceat(vals, ptr[nz])
    return out


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


# -- pass 1: lane construction ------------------------------------------------

class _Lanes:
    """Vectorized lane streams (see module DESIGN §1)."""

    __slots__ = ("row", "seg", "width", "ptr", "final", "cin", "cout",
                 "ent_cols", "ent_vals", "ent_src", "lvl", "lvl_ptr",
                 "n_carry", "count", "has_splits", "nnz")

    def __init__(self, A: CSR, level_of: np.ndarray, num_levels: int,
                 max_deps: int):
        n = A.n_rows
        indptr = np.asarray(A.indptr, dtype=np.int64)
        deg = np.diff(indptr)
        rord = np.lexsort((np.arange(n), level_of))
        identity = bool(np.array_equal(rord, np.arange(n)))
        deg_o = deg if identity else deg[rord]
        self.nnz = int(indptr[-1])
        self.ent_src = None     # packed-entry order == data order
        self.has_splits = bool((deg_o > max_deps).any())
        if not self.has_splits:
            # fast path: one lane per row, dep lists stay CSR-contiguous
            self.count = n
            self.row = rord
            self.seg = np.zeros(n, dtype=np.int64)
            self.final = np.ones(n, dtype=bool)
            self.width = deg_o
            if identity:
                self.ent_cols = np.asarray(A.indices, dtype=np.int64)
                self.ent_vals = A.data
                self.ptr = indptr
            else:
                ent_gather = np.repeat(indptr[rord], deg_o) + \
                    _segment_arange(deg_o)
                self.ent_cols = A.indices[ent_gather].astype(np.int64)
                self.ent_vals = A.data[ent_gather]
                self.ent_src = ent_gather
                self.ptr = np.zeros(n + 1, dtype=np.int64)
                np.cumsum(deg_o, out=self.ptr[1:])
            self.n_carry = 1
            self.cin = np.full(n, self.n_carry, dtype=np.int64)
            self.cout = np.full(n, self.n_carry + 1, dtype=np.int64)
        else:
            nseg = np.maximum(1, -(-deg_o // max_deps))
            self.count = int(nseg.sum())
            lane_start = np.cumsum(nseg) - nseg
            final_idx = lane_start + nseg - 1
            self.row = np.repeat(rord, nseg)
            self.seg = _segment_arange(nseg)
            self.final = np.zeros(self.count, dtype=bool)
            self.final[final_idx] = True
            self.width = np.full(self.count, max_deps, dtype=np.int64)
            self.width[final_idx] = deg_o - (nseg - 1) * max_deps
            # lane dep lists are contiguous in lane order (segments tile each
            # row's CSR range consecutively): regather only if rows moved
            if identity:
                self.ent_cols = np.asarray(A.indices, dtype=np.int64)
                self.ent_vals = A.data
            else:
                ent_gather = np.repeat(indptr[rord], deg_o) + \
                    _segment_arange(deg_o)
                self.ent_cols = A.indices[ent_gather].astype(np.int64)
                self.ent_vals = A.data[ent_gather]
                self.ent_src = ent_gather
            self.ptr = np.zeros(self.count + 1, dtype=np.int64)
            np.cumsum(self.width, out=self.ptr[1:])
            # carry slots: nseg-1 per split row, chained in segment order
            # (slot ids assigned to the few non-final lanes by scatter)
            split_rows = np.flatnonzero(nseg > 1)
            cnts = nseg[split_rows] - 1
            self.n_carry = max(int(cnts.sum()), 1)
            nonfinal = np.repeat(lane_start[split_rows], cnts) + \
                _segment_arange(cnts)
            slots = np.arange(nonfinal.size, dtype=np.int64)
            self.cin = np.full(self.count, self.n_carry, dtype=np.int64)
            self.cin[nonfinal + 1] = slots
            self.cout = np.full(self.count, self.n_carry + 1, dtype=np.int64)
            self.cout[nonfinal] = slots
        self.lvl = level_of[self.row]
        self.lvl_ptr = np.searchsorted(self.lvl, np.arange(num_levels + 1))


# -- pass 2a: level-aligned step assignment (legacy layout, vectorized) -------

def _assign_level_aligned(lanes: _Lanes, num_levels: int, chunk: int):
    """Each level -> its own run of steps; split segments in distinct
    sub-steps; `chunk` lanes per step.  Pure bincount/cumsum arithmetic."""
    if lanes.count == 0:
        return np.zeros(0, dtype=np.int64), max(num_levels, 0)
    # global sort by (level, seg, row): groups are (level, seg) buckets
    order = np.lexsort((lanes.row, lanes.seg, lanes.lvl))
    glvl, gseg = lanes.lvl[order], lanes.seg[order]
    new = np.ones(lanes.count, dtype=bool)
    new[1:] = (np.diff(glvl) != 0) | (np.diff(gseg) != 0)
    gid = np.cumsum(new) - 1
    starts = np.flatnonzero(new)
    counts = np.diff(np.append(starts, lanes.count))
    rank = np.arange(lanes.count) - starts[gid]
    steps_per_grp = -(-counts // chunk)
    # per-level step totals (empty levels still get one step, like legacy)
    grp_lvl = glvl[starts]
    steps_per_level = np.zeros(num_levels, dtype=np.int64)
    np.add.at(steps_per_level, grp_lvl, steps_per_grp)
    steps_per_level = np.maximum(steps_per_level, 1)
    level_base = np.zeros(num_levels, dtype=np.int64)
    level_base[1:] = np.cumsum(steps_per_level)[:-1]
    # exclusive cumsum of group steps, reset at each level's first group
    gcum = np.zeros(len(steps_per_grp), dtype=np.int64)
    gcum[1:] = np.cumsum(steps_per_grp)[:-1]
    grp_new_lvl = np.ones(len(grp_lvl), dtype=bool)
    grp_new_lvl[1:] = np.diff(grp_lvl) != 0
    lvl_first_cum = gcum[grp_new_lvl]
    within = gcum - lvl_first_cum[np.cumsum(grp_new_lvl) - 1]
    step_sorted = level_base[glvl] + within[gid] + rank // chunk
    lane_step = np.empty(lanes.count, dtype=np.int64)
    lane_step[order] = step_sorted
    return lane_step, int(steps_per_level.sum())


# -- pass 2b: dependency-aware step compaction --------------------------------

def _levels_are_tight(A: CSR, level_of: np.ndarray) -> bool:
    """level(i) == 1 + max(level(dep)) for every row (recomputed levels)."""
    indptr = np.asarray(A.indptr, dtype=np.int64)
    m = _segment_max(level_of[A.indices], indptr, empty=-1)
    return bool(np.array_equal(level_of, m + 1))


def _assign_compact(lanes: _Lanes, A: CSR, level_of: np.ndarray,
                    num_levels: int, chunk: int):
    """Greedy dependency-aware list scheduling (module DESIGN §2).

    Fast paths exploit *tight* levels (level == 1 + max dep level): while the
    previous level landed entirely in the current frontier step, every lane
    of the next level has earliest-step exactly frontier+1, so runs of
    regular levels are batch-assigned without touching the dependency lists.
    Oversized levels and spill-recovery zones fall back to honest per-lane
    earliest-step computation with capacity backfill, which is what lets
    under-full steps absorb rows from later levels.
    """
    n = A.n_rows
    if lanes.count == 0:
        return np.zeros(0, dtype=np.int64), 0
    tight = _levels_are_tight(A, level_of)
    S_fin = np.full(n, -1, dtype=np.int64)          # step finalizing each row
    lane_step = np.zeros(lanes.count, dtype=np.int64)
    lvl_ptr = lanes.lvl_ptr
    lvl_sizes = np.diff(lvl_ptr)
    split_lane = ~lanes.final | (lanes.seg > 0)
    has_split = np.zeros(num_levels, dtype=bool)
    if lanes.has_splits:
        np.logical_or.at(has_split, lanes.lvl[split_lane], True)
    regular = (lvl_sizes <= chunk) & ~has_split
    if not tight:
        regular[:] = False      # skipped levels => always schedule honestly
    # next non-regular level at or after l (for clean-run batching)
    nxt = np.where(~regular, np.arange(num_levels), num_levels)
    nxt = np.minimum.accumulate(nxt[::-1])[::-1]
    occ = np.zeros(num_levels + 64, dtype=np.int64)

    def _ensure_occ(hi):
        nonlocal occ
        if hi >= occ.size:
            occ = np.concatenate(
                [occ, np.zeros(max(hi + 1 - occ.size, occ.size), np.int64)])

    max_step = -1
    # `uniform` <=> all rows of the previous level sit in step `max_step`
    # (then tight levels give est == max_step + 1 for every next-level lane,
    # so batch placement is *lossless*).  `stalled` <=> the last honest
    # level found no backfillable slack; batching is then merely *valid*
    # (est <= max_step + 1 always) and we stop paying for honest scans.
    uniform = True
    stalled = False
    lvl = 0
    while lvl < num_levels:
        lo = int(lvl_ptr[lvl])
        if tight and regular[lvl] and (uniform or stalled):
            # batch run lvl..end-1: one fresh step per level
            end = max(int(nxt[lvl]), lvl + 1)
            hi = int(lvl_ptr[end])
            sl = slice(lo, hi)
            base = max_step + 1 - lvl
            steps = lanes.lvl[sl] + base
            lane_step[sl] = steps
            S_fin[lanes.row[sl]] = steps        # batched lanes are all final
            _ensure_occ(end - 1 + base)
            occ[lvl + base:end + base] += lvl_sizes[lvl:end]
            max_step = end - 1 + base
            uniform = True
            lvl = end
            continue
        hi = int(lvl_ptr[lvl + 1])
        if hi == lo:
            lvl += 1
            continue
        size = hi - lo
        if tight and uniform and not has_split[lvl]:
            # oversized level, uniform est: chunked run of fresh steps
            sl = slice(lo, hi)
            steps = max_step + 1 + np.arange(size) // chunk
            lane_step[sl] = steps
            S_fin[lanes.row[sl]] = steps
            nsteps = -(-size // chunk)
            _ensure_occ(max_step + nsteps)
            occ[max_step + 1:max_step + 1 + nsteps] = chunk
            occ[max_step + nsteps] = size - (nsteps - 1) * chunk
            max_step += nsteps
            uniform = nsteps == 1
            stalled = False     # the partial tail step is fresh slack
            lvl += 1
            continue
        # honest earliest-step per lane: 1 + max step of the rows it reads
        ecols = lanes.ent_cols[lanes.ptr[lo]:lanes.ptr[hi]]
        lptr = lanes.ptr[lo:hi + 1] - lanes.ptr[lo]
        if tight:       # every lane of a tight level > 0 has deps
            est = np.maximum.reduceat(S_fin[ecols], lptr[:-1]) + 1
        else:
            est = _segment_max(S_fin[ecols], lptr, empty=-1) + 1
        sp = split_lane[lo:hi] if lanes.has_splits else None
        simple = np.flatnonzero(~sp) if sp is not None else None
        prev_max = max_step
        lvl_max = -1
        lvl_min = 1 << 60
        # vectorized capacity cascade for simple (one-segment) lanes
        e = est if simple is None else est[simple]
        if e.size:
            emin, emax = int(e.min()), int(e.max())
            if emin == emax:
                order, t = None, e
            else:
                order = np.argsort(e, kind="stable")
                t = e[order]
            _ensure_occ(emax + e.size // chunk + 2)
            while True:
                mn, mx = int(t[0]), int(t[-1])
                cnts = np.bincount(t - mn, minlength=mx - mn + 1)
                free = chunk - occ[mn:mx + 1]       # occ <= chunk invariant
                if (cnts <= free).all():
                    break
                if order is None:       # cascade may break uniformity
                    order = np.arange(e.size)
                    t = t.copy()
                rank = np.arange(t.size) - np.searchsorted(t, t)
                t[rank >= free[t - mn]] += 1
                _ensure_occ(int(t[-1]) + 1)
            occ[mn:mx + 1] += cnts
            if order is None:
                idx = slice(lo, hi) if simple is None else lo + simple
            else:
                idx = lo + (order if simple is None else simple[order])
            lane_step[idx] = t
            S_fin[lanes.row[idx]] = t
            lvl_min, lvl_max = int(t[0]), int(t[-1])
        # split-row segments: rare; place one by one, chaining steps
        if sp is not None:
            prev_row, prev_t = -1, -1
            for k in np.flatnonzero(sp):
                ln = lo + int(k)
                r = int(lanes.row[ln])
                t = int(est[k])
                if r == prev_row:
                    t = max(t, prev_t + 1)
                _ensure_occ(t + 1)
                while occ[t] >= chunk:
                    t += 1
                    _ensure_occ(t + 1)
                occ[t] += 1
                lane_step[ln] = t
                if lanes.final[ln]:
                    S_fin[r] = t
                prev_row, prev_t = r, t
                lvl_min = min(lvl_min, t)
                lvl_max = max(lvl_max, t)
        uniform = lvl_min == lvl_max and lvl_max >= max_step
        stalled = lvl_min > prev_max      # honest scan found no slack
        max_step = max(max_step, lvl_max)
        lvl += 1
    return lane_step, max_step + 1


# -- passes 3+4: width bucketing and tile materialization ---------------------

def _bucket_widths(widths, max_deps: int, wmax: int):
    """Effective bucket boundaries: configured widths clipped to the widest
    real lane, always covering it."""
    wmax = max(int(wmax), 1)
    cand = sorted({min(int(w), max_deps, wmax) for w in widths if w > 0})
    if not cand or cand[-1] < wmax:
        cand.append(wmax)
    return cand


def _materialize(lanes: _Lanes, lane_step: np.ndarray, num_steps: int,
                 diag: np.ndarray, n: int, widths, max_deps: int,
                 dtype, force_tile=None) -> tuple:
    """Fill every width group's ELL tiles in one globally vectorized pass:
    lanes are sorted once by (group, step), per-group tiles live in two
    concatenated buffers (lane scalars / dep slots) sliced into views, and
    all scatters run over the full lane / entry population at once.

    Lane capacity per step is already bounded by `chunk` upstream (step
    assignment); C_g here is just the realized per-class maximum, rounded
    to the sublane tile.  force_tile=(C, D) pins a single group to a fixed
    tile shape (the legacy chunk x max_deps layout) for apples-to-apples
    benchmarking."""
    wmax = int(lanes.width.max()) if lanes.count else 1
    if force_tile is not None:
        buckets = np.asarray([force_tile[1]], dtype=np.int64)
        gi = np.zeros(lanes.count, dtype=np.int64)
    else:
        buckets = np.asarray(_bucket_widths(widths, max_deps, wmax),
                             dtype=np.int64)
        gi = np.searchsorted(buckets, np.maximum(lanes.width, 1))
        # drop empty width classes (keep at least one)
        pop = np.bincount(gi, minlength=len(buckets))
        if (pop == 0).any() and len(buckets) > 1:
            keep = pop > 0
            if not keep.any():
                keep[0] = True
            buckets = buckets[keep]
            gi = (np.cumsum(keep) - 1)[gi]
    G = len(buckets)
    S = num_steps       # 0 only for an empty system (no lanes at all)
    dinv_of = np.zeros(n + 1, dtype=dtype)
    if n:
        dinv_of[:n] = 1.0 / np.asarray(diag, dtype=dtype)
    ent_vals = lanes.ent_vals if lanes.ent_vals.dtype == dtype \
        else lanes.ent_vals.astype(dtype)
    # one stable sort by (group, step) gives every lane its tile slot
    key = gi * S + lane_step
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    cnt = np.bincount(key_s, minlength=G * S)
    if force_tile is not None:
        Cg = np.asarray([force_tile[0]], dtype=np.int64)
    else:
        Cg = np.maximum(
            8, ((cnt.reshape(G, S).max(axis=1, initial=0) + 7) // 8) * 8)
    base = np.zeros(G * S, dtype=np.int64)
    base[1:] = np.cumsum(cnt)[:-1]
    rank = np.arange(lanes.count) - base[key_s]
    gi_s = gi[order]
    flat = lane_step[order] * Cg[gi_s] + rank     # slot in (S, C_g) grid
    loff = np.zeros(G + 1, dtype=np.int64)        # lane-scalar buffer offsets
    np.cumsum(S * Cg, out=loff[1:])
    slot = loff[gi_s] + flat
    Dg = buckets
    doff = np.zeros(G + 1, dtype=np.int64)        # dep-slot buffer offsets
    np.cumsum(S * Cg * Dg, out=doff[1:])
    # lane scalars (padding: row n, dinv 0)
    row_buf = np.full(loff[-1], n, dtype=np.int32)
    dinv_buf = np.zeros(loff[-1], dtype=dtype)
    fin = lanes.final[order]
    rows = lanes.row[order]
    if lanes.has_splits and not fin.all():
        row_buf[slot] = np.where(fin, rows, n)
        dinv_buf[slot] = np.where(fin, dinv_of[rows], 0)
    else:
        row_buf[slot] = rows
        dinv_buf[slot] = dinv_of[rows]
    cin_buf = cout_buf = None
    if lanes.has_splits:
        # padding reads the always-zero slot n_carry, writes the sink
        cin_buf = np.full(loff[-1], lanes.n_carry, dtype=np.int32)
        cout_buf = np.full(loff[-1], lanes.n_carry + 1, dtype=np.int32)
        cin_buf[slot] = lanes.cin[order]
        cout_buf[slot] = lanes.cout[order]
    # dep slots (padding gathers x[0] with coef 0 — inert, and np.zeros
    # keeps the pad pages untouched)
    dep_idx_buf = np.zeros(doff[-1], dtype=np.int32)
    dep_coef_buf = np.zeros(doff[-1], dtype=dtype)
    dep_base = np.empty(lanes.count, dtype=np.int64)   # back to lane order
    dep_base[order] = doff[gi_s] + flat * Dg[gi_s]
    dst = np.repeat(dep_base, lanes.width) + \
        (np.arange(lanes.ptr[-1]) - np.repeat(lanes.ptr[:-1], lanes.width))
    dep_idx_buf[dst] = lanes.ent_cols
    dep_coef_buf[dst] = ent_vals
    plan = SchedValuePlan(nnz=lanes.nnz, ent_src=lanes.ent_src, coef_dst=dst,
                          lane_slot=slot, lane_row=rows, lane_final=fin)
    groups = []
    for g in range(G):
        C, D = int(Cg[g]), int(Dg[g])
        sl = slice(int(loff[g]), int(loff[g + 1]))
        dsl = slice(int(doff[g]), int(doff[g + 1]))
        carry_in = carry_out = None
        if cin_buf is not None:
            cin_v = cin_buf[sl]
            cout_v = cout_buf[sl]
            if not (cin_v == lanes.n_carry).all() or \
                    not (cout_v == lanes.n_carry + 1).all():
                carry_in = cin_v.reshape(S, C)
                carry_out = cout_v.reshape(S, C)
        groups.append(WidthGroup(
            width=D, n=n,
            row_ids=row_buf[sl].reshape(S, C),
            dep_idx=dep_idx_buf[dsl].reshape(S, C, D),
            dep_coef=dep_coef_buf[dsl].reshape(S, C, D),
            dinv=dinv_buf[sl].reshape(S, C),
            carry_in=carry_in,
            carry_out=carry_out))
    return tuple(groups), plan


# -- driver -------------------------------------------------------------------

def build_schedule(A: CSR, diag: np.ndarray, level_of: np.ndarray,
                   chunk: int = 256, max_deps: int = 16,
                   dtype=np.float32, compact: bool = True,
                   widths=DEFAULT_WIDTHS,
                   legacy_shape: bool = False) -> LevelSchedule:
    """Compile (A strict-lower, diag, level assignment) into a LevelSchedule.

    compact=True runs dependency-aware step compaction; widths sets the
    ELL bucket boundaries (clipped to max_deps / the widest real lane).
    legacy_shape=True reproduces the original fixed chunk x max_deps tile
    layout (one group, no compaction) — the benchmarking baseline.
    """
    t0 = time.perf_counter()
    n = A.n_rows
    num_levels = int(level_of.max()) + 1 if n else 0
    lanes = _Lanes(A, np.asarray(level_of, dtype=np.int64), num_levels,
                   max_deps)
    if compact and not legacy_shape:
        lane_step, num_steps = _assign_compact(
            lanes, A, np.asarray(level_of, dtype=np.int64), num_levels, chunk)
    else:
        lane_step, num_steps = _assign_level_aligned(lanes, num_levels, chunk)
    groups, plan = _materialize(
        lanes, lane_step, num_steps, diag, n, widths, max_deps, dtype,
        force_tile=(chunk, max_deps) if legacy_shape else None)
    build_ms = (time.perf_counter() - t0) * 1e3
    return LevelSchedule(groups=groups, n=n, n_carry=lanes.n_carry,
                         num_levels=num_levels, chunk=chunk,
                         max_deps=max_deps,
                         compacted=compact and not legacy_shape,
                         build_ms=build_ms, value_plan=plan)


def repack_schedule_values(sched: LevelSchedule, new_data: np.ndarray,
                           new_diag: np.ndarray) -> LevelSchedule:
    """Refill a schedule's numeric payload for new values on the frozen
    pattern — the value-update fast path.

    Only `dep_coef` and `dinv` change; `row_ids`/`dep_idx`/carry arrays (the
    pattern-derived structure) are shared with the input schedule, so no
    lane construction, step assignment, or width bucketing runs.  Fresh
    buffers are allocated (never mutated in place): compiled engine
    functions and staged device arrays may still reference the old ones.

    `new_data` must be in the same entry order as the matrix the schedule
    was built from (`sched.value_plan.nnz` entries); the result is bitwise
    identical to `build_schedule` on the new values.
    """
    plan = sched.value_plan
    if plan is None:
        raise ValueError(
            "schedule carries no SchedValuePlan — it was not produced by "
            "build_schedule; rebuild instead of repacking")
    vals = np.asarray(new_data)
    if vals.shape != (plan.nnz,):
        raise ValueError(
            f"repack_schedule_values: expected {plan.nnz} values for the "
            f"frozen pattern, got shape {vals.shape}")
    t0 = time.perf_counter()
    dtype = sched.dtype
    n = sched.n
    # buffer geometry reconstructed from the materialized group shapes
    lsizes = [g.row_ids.size for g in sched.groups]
    dsizes = [g.dep_idx.size for g in sched.groups]
    dinv_of = np.zeros(n + 1, dtype=dtype)
    if n:
        dinv_of[:n] = 1.0 / np.asarray(new_diag, dtype=dtype)
    ent_vals = vals if plan.ent_src is None else vals[plan.ent_src]
    if ent_vals.dtype != dtype:
        ent_vals = ent_vals.astype(dtype)
    dep_coef_buf = np.zeros(sum(dsizes), dtype=dtype)
    dep_coef_buf[plan.coef_dst] = ent_vals
    dinv_buf = np.zeros(sum(lsizes), dtype=dtype)
    if plan.lane_final.all():
        dinv_buf[plan.lane_slot] = dinv_of[plan.lane_row]
    else:
        dinv_buf[plan.lane_slot] = np.where(plan.lane_final,
                                            dinv_of[plan.lane_row], 0)
    groups = []
    lo = do = 0
    for g, ls, ds in zip(sched.groups, lsizes, dsizes):
        groups.append(dataclasses.replace(
            g, dep_coef=dep_coef_buf[do:do + ds].reshape(g.dep_coef.shape),
            dinv=dinv_buf[lo:lo + ls].reshape(g.dinv.shape)))
        lo += ls
        do += ds
    build_ms = (time.perf_counter() - t0) * 1e3
    return dataclasses.replace(sched, groups=tuple(groups), build_ms=build_ms)


def schedule_for_csr(L: CSR, levels: LevelSets, chunk: int = 256,
                     max_deps: int = 16, dtype=np.float32,
                     compact: bool = True,
                     widths=DEFAULT_WIDTHS) -> LevelSchedule:
    """Schedule for an untransformed lower-triangular L (diag inside L)."""
    from ..sparse.csr import tril
    A = tril(L, keep_diagonal=False)
    return build_schedule(A, L.diagonal_fast(), levels.level_of,
                          chunk=chunk, max_deps=max_deps, dtype=dtype,
                          compact=compact, widths=widths)


def schedule_for_transformed(ts, assigned: bool = False, chunk: int = 256,
                             max_deps: int = 16, dtype=np.float32,
                             compact: bool = True,
                             widths=DEFAULT_WIDTHS) -> LevelSchedule:
    """Schedule for a TransformedSystem (A', d) — preamble handled separately."""
    lof = ts.level_of_assigned if assigned else ts.level_of_recomputed
    return build_schedule(ts.A, ts.diag, lof, chunk=chunk, max_deps=max_deps,
                          dtype=dtype, compact=compact, widths=widths)


def schedule_for_preamble(ts, chunk: int = 256, max_deps: int = 16,
                          dtype=np.float32, compact: bool = True,
                          widths=DEFAULT_WIDTHS):
    """The b-preamble c = (I+T)^{-1} b[src] is ITSELF a unit-diagonal
    triangular system over entities — so it runs through the same
    level-scheduled engines/kernels as the main solve.

    Entity ids are not topologically ordered (aux ids exceed the row ids
    they feed), so entities are renumbered by (src, id) — strictly
    topological because every reference targets a smaller source row.

    Returns (schedule, src_sorted, row_pos): the schedule solves
    (I+T') c' = b[src_sorted]; c[i] = c'[row_pos[i]] for original rows i.
    Returns (None, None, None) for identity preambles.
    """
    if ts.T.nnz == 0:
        return None, None, None
    from ..sparse.csr import from_coo
    from ..sparse.levels import build_levels
    from ..core.transform import _with_diag
    T, src = ts.T, ts.src
    n_ent = T.n_rows
    perm = np.lexsort((np.arange(n_ent), src))       # old id -> rank by src
    inv = np.empty(n_ent, dtype=np.int64)
    inv[perm] = np.arange(n_ent)
    rows_old = np.repeat(np.arange(n_ent), T.row_nnz())
    T2 = from_coo(inv[rows_old], inv[T.indices], T.data, (n_ent, n_ent))
    lv = build_levels(_with_diag(T2))
    sched = build_schedule(T2, np.ones(n_ent), lv.level_of, chunk=chunk,
                           max_deps=max_deps, dtype=dtype, compact=compact,
                           widths=widths)
    # Compose the (pattern-only) T -> T2 renumbering permutation into the
    # value plan, so a pattern-frozen repack consumes T.data directly.  The
    # from_coo above mirrors its own lexsort; duplicate (row, col) pairs in
    # T would be value-summed by it (none of the shipped strategies produce
    # them) — the equality check drops the plan rather than risk a wrong
    # repack, and callers fall back to rebuilding the preamble schedule.
    t2_perm = np.lexsort((inv[T.indices], inv[rows_old]))
    plan = sched.value_plan
    if T2.nnz == T.nnz and plan is not None \
            and np.array_equal(T2.data, T.data[t2_perm]):
        ent_src = t2_perm if plan.ent_src is None else t2_perm[plan.ent_src]
        plan = dataclasses.replace(plan, nnz=T.nnz, ent_src=ent_src)
    else:
        plan = None
    sched = dataclasses.replace(sched, value_plan=plan)
    return sched, src[perm], inv[:ts.A.n_rows]


def validate_schedule(sched: LevelSchedule, A: CSR, diag: np.ndarray) -> None:
    """Structural audit of a compiled schedule.  Thin shim over the full
    verifier (`repro_torch.analysis.verify.verify_level_schedule`), kept
    for the reference's call sites and tests; new code should call the
    verifier directly and keep the returned `ScheduleCertificate`.  Raises
    `ScheduleInvariantError` on violation."""
    from ..analysis.verify import verify_level_schedule
    verify_level_schedule(sched, A, diag, where="validate_schedule")
