"""Level-scheduled SpTRSV on Hopper: the CUDA kernel's wrappers and packing.

Replaces the Pallas TPU kernels of `src/repro/kernels/sptrsv_level.py`:
  * K1 `sptrsv_groups_pallas` (one right-hand side)   -> `sptrsv_groups`
  * K2 `sptrsv_groups_pallas_multi` ((n+1, R) c_pad)  -> `sptrsv_groups_multi`
  * K3 `sptrsv_levels_pallas` (legacy flat signature) -> `sptrsv_levels`,
    a thin wrapper over K1 that adds no kernel.

What bounds it on the H100: the chain of dependent steps, not bytes.  A
solve moves the schedule, c and x once (a few MB, microseconds at
3.35 TB/s), while every step pays a dependent gather of x, an FMA chain, a
store and a barrier, and every warp in the step its bookkeeping.  So the
design cuts the number of steps to the dependency DAG's depth and
shortens each step:

* **Dependency-exact packing** (`pack_groups`, on the host, once per
  schedule).  The schedule compiler caps a step at `chunk` lanes and
  splits rows longer than `max_deps` into chains of partial lanes linked
  by carry slots, one step per link.  The packing fuses every carry chain
  back into one lane holding all of its row's deps, then re-levels: a
  lane's step is 1 + the latest step of the rows it reads, with no cap on
  lanes per step.  The kernel's steps then equal the DAG's level count
  (lung2's backward IC(0) sweep: 2,717 schedule steps -> 479), and it
  needs no carry buffer.
* **Tiles.**  Each step's lanes (long lanes first, then by row) are cut
  into tiles of at most one ring stage's bytes: a 16-byte header
  (lanes, long lanes, flags: the tile ends its step, the tile is a run of
  narrow steps), one 16-byte record per lane (row, 1/diag, dep offset,
  dep count with bit 31 set on the last lane of its step) and the lane's
  (index, coefficient) pairs, the tile padded to 16 bytes.  Consecutive
  narrow steps (at most `NARROW_LANES` lanes, none long) share a tile,
  which consumer warp 0 solves alone; a wider step has tiles of its own.
  `tile_ptr` gives each tile's offset in 16-byte units.
* **Rows longer than a tile** (more than `FAR_DEPS` deps: arrow or
  circuit patterns, a dense column of an IC(0) factor) keep their pairs
  in `far`, in device memory, and their record points there (a negative
  dep offset); a tile never outgrows a ring stage, whatever the rows.
* **Dependency-free rows** (`x = c / diag`: the whole first level) go to
  a multi-block pass that runs first on the same stream (lung2's
  backward sweep has 108,648 of them).
* **Block size** (`consumer_threads`): the consumer warps that minimize
  a cost of the wide steps for this schedule and R (each warp's
  bookkeeping against the rounds of items a thread takes, one ratio
  fitted on the card), cached per R.

The kernel (`csrc/sptrsv_level.cu`) streams the tiles through a ring of
`RING_BYTES` in shared memory with TMA bulk copies and one block of up to
1024 threads; a thread's item is a short lane and one column, or with
R % 4 == 0 four columns (`items_per_lane`); its design notes are in the
source.  `emulate_packed` runs its per-tile,
per-step loop in torch on the same packed arrays, writes of a step
becoming visible only at the step's end, so a packing bug fails the CPU
tests.

* **Value refresh** (`refresh_packed_values`).  The packing keeps a map
  of where each value landed (`ValueMap`: the tile or `far` word of every
  kept coefficient and of every 1/diag, keyed by the schedule's flat value
  slot).  New values on the same schedule layout (a value update on a
  frozen pattern) are written through it on the device, one gather and
  one scatter per array, into clones of `tiles` and `far`: no host
  re-pack.  Because the packing drops coefficients that are 0 and
  re-levels without them, a refresh first compares the new zero set with
  the dropped one; when they differ it packs the new schedule anew.

K1's stamped form (`sptrsv_groups_stamped`) is the same kernel compiled
with clock64() stamps at the end of every tile step, for the per-step
profile (`repro_torch.obs.profile`); the free pass runs as its own launch
so that events time it alone.

Dispatch: a wrapper given CPU tensors runs the plain version
(`kernels/ref.py`) and counts it under "plain"; given CUDA tensors it
launches the kernel or raises.  `LAUNCHES` counts solves per entry point
(one per solve, the dependency-free pass included); `PACKS` counts host
packs, device value refreshes, and the refreshes that had to re-pack.
Both are `kernels.counts.Counts`, whose increments are atomic across the
threads that launch at once (a solve service's workers and its tuner).
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import time
import weakref

import numpy as np
import torch

from . import ref
from .counts import Counts

__all__ = ["PackedSchedule", "ValueMap", "pack_groups", "pack_schedule",
           "refresh_packed_values", "schedule_values", "PACKS",
           "unpack_tiles", "emulate_packed", "sptrsv_groups",
           "sptrsv_groups_multi", "sptrsv_levels", "sptrsv_groups_stamped",
           "StampedSolve", "step_flops", "step_bytes",
           "LAUNCHES", "reset_launch_counts", "consumer_threads",
           "consumer_terms", "items_per_lane", "LONG_DEPS", "FAR_DEPS"]

# launches per entry point: K1, K2, K3 (which launches through K1), K1's
# stamped form, and the plain version taken for CPU tensors
LAUNCHES = Counts("sptrsv_groups", "sptrsv_groups_multi", "sptrsv_levels",
                  "sptrsv_groups_stamped", "plain")

LONG_DEPS = 32              # a lane with more deps is summed by a warp,
LONG_CHUNK = 32 * 8         # which gathers this many of them per round
FAR_DEPS = 4096             # a lane with more deps reads them from `far`
HEADER_WORDS = 4            # tile header: 4 int32
LANE_WORDS = 4              # lane record: row, 1/diag bits, dep offset, count
MIN_STAGE_BYTES = 16 << 10  # a ring stage holds at least 16 KB
RING_BYTES = 96 << 10       # the ring's shared memory (of 227 KB; the rest
                            # of the SM's 256 KB serves as L1 for x)
MAX_STAGES = 16             # the kernel's mbarrier pairs
MAX_CONSUMERS = 992         # 31 consumer warps + 1 producer warp = 1024
NARROW_LANES = 32           # a step of at most this many lanes (none long) is
                            # solved by consumer warp 0 alone, in a run of
                            # such steps that share a tile
# choosing the consumer warps: every consumer warp adds its bookkeeping
# to each wide step (its header reads, its arrival on the stage's
# mbarrier, its share of the step barrier), and every round of items past
# the first that a thread takes in one step adds a dependent trip to L2
# for c and x, which costs as much as ROUND_WARPS warps' bookkeeping:
# fitted on an H100 by `chip_smoke.py --sweep` (from 62 to 91 every value
# makes the same choices on lung2's and torso2's sweeps at R = 1 and 8)
ROUND_WARPS = 75.0


# host packs (`pack_groups`), value refreshes on the packed arrays, and
# the refreshes that found the zero set moved and re-packed
PACKS = Counts("pack_groups", "refreshes", "repacks")


def reset_launch_counts() -> None:
    LAUNCHES.reset()


# the library's entry points and their C argument types
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "sptrsv_tiles_launch": [_PTR, _PTR, _INT, _PTR, _PTR, _PTR, _INT, _PTR,
                            _PTR] + [_INT] * 4 + [_PTR],
    "sptrsv_free_launch": [_PTR, _PTR, _INT, _PTR, _PTR, _PTR],
    "sptrsv_tiles_stamped_launch": [_PTR, _PTR, _INT, _PTR, _PTR, _PTR] +
                                   [_INT] * 3 + [_PTR, _PTR],
}


def _entry(name: str):
    from .build import entry_points
    return entry_points("sptrsv_level", _SIGNATURES)[name]


@dataclasses.dataclass(frozen=True, eq=False)
class ValueMap:
    """Where `pack_groups` put each value of the schedule it packed, as
    host arrays (int64).  A source indexes the schedule's flat value buffer
    (`schedule_values`: every group's dep_coef raveled in group order, then
    every group's dinv).

    tile_word, tile_src   words of `tiles` holding float32 values (each
                          kept coefficient and each tile lane's 1/diag) and
                          their sources
    far_word, far_src     the same for the coefficients kept in `far`
    free_src              the source of each `free_dinv` entry
    kept, dropped         dep_coef slots of the real lanes that the packing
                          kept (non-zero) and dropped (zero)
    coef_slots, dinv_slots  the sizes of the buffer's two parts

    `staged(device)` holds the index arrays as device tensors, once per
    device (never pickled).
    """

    tile_word: np.ndarray
    tile_src: np.ndarray
    far_word: np.ndarray
    far_src: np.ndarray
    free_src: np.ndarray
    kept: np.ndarray
    dropped: np.ndarray
    coef_slots: int
    dinv_slots: int
    _staged: dict = dataclasses.field(default_factory=dict, repr=False)

    def staged(self, device) -> tuple:
        """(tile_word, tile_src, far_word, far_src, free_src) on device."""
        key = str(torch.device(device))
        got = self._staged.get(key)
        if got is None:
            got = self._staged[key] = tuple(
                torch.from_numpy(a).to(device) for a in (
                    self.tile_word, self.tile_src, self.far_word,
                    self.far_src, self.free_src))
        return got

    def __getstate__(self):
        return dict(self.__dict__, _staged={})


@dataclasses.dataclass(frozen=True)
class PackedSchedule:
    """A schedule in the kernel's dependency-exact tiled form.

    tiles (W,) int32          the tile stream (module doc), W % 4 == 0
    tile_ptr (T+1,) int32     tile t is tiles[4*tile_ptr[t]:4*tile_ptr[t+1]]
    far (2P,) int32           (index, coefficient) pairs of the lanes of
                              more than FAR_DEPS deps; such a lane's dep
                              offset is ~(its first pair)
    free_row (F,) int32       rows of the dependency-free pass, ascending
    free_dinv (F,) float32    their 1/diag
    num_steps                 DAG levels: the free pass (when F > 0) is
                              step 0, the tiles hold the rest
    schedule_steps            the schedule's steps before re-levelling
    stage_bytes, num_stages   the ring the tiles were cut for
    step_short, step_long     short lanes of each tile step, and its long
                              lanes' rounds of LONG_CHUNK deps (host
                              numpy), from which the launch sizes the block
    step_rows, step_deps      rows and deps of each of the num_steps steps,
                              the free pass's first (host numpy)
    values                    where each value of the schedule landed
                              (`ValueMap`), for `refresh_packed_values`
    """

    tiles: torch.Tensor
    tile_ptr: torch.Tensor
    far: torch.Tensor
    free_row: torch.Tensor
    free_dinv: torch.Tensor
    n: int
    n_carry: int
    num_steps: int
    schedule_steps: int
    stage_bytes: int
    num_stages: int
    step_short: np.ndarray
    step_long: np.ndarray
    step_rows: np.ndarray
    step_deps: np.ndarray
    num_lanes: int
    num_deps: int
    long_lanes: int
    widest_step: int
    pack_s: float
    consumers: dict = dataclasses.field(default_factory=dict, repr=False,
                                        compare=False)
    values: ValueMap | None = dataclasses.field(default=None, repr=False,
                                                compare=False)

    @property
    def num_tiles(self) -> int:
        return int(self.tile_ptr.shape[0]) - 1

    @property
    def num_free(self) -> int:
        return int(self.free_row.shape[0])

    @property
    def launches(self) -> int:
        """Kernel launches of one solve: the free pass and the tiles."""
        return int(self.num_free > 0) + int(self.num_tiles > 0)

    def tensors(self) -> tuple:
        return (self.tiles, self.tile_ptr, self.far, self.free_row,
                self.free_dinv)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors())

    def to(self, device) -> "PackedSchedule":
        return dataclasses.replace(
            self, **{f.name: getattr(self, f.name).to(device)
                     for f in dataclasses.fields(self)
                     if isinstance(getattr(self, f.name), torch.Tensor)})


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _segment_arange(lens: np.ndarray) -> np.ndarray:
    if lens.size == 0:
        return np.zeros(0, dtype=np.int64)
    starts = np.cumsum(lens) - lens
    return np.arange(int(lens.sum()), dtype=np.int64) - \
        np.repeat(starts, lens)


def _ptr(cnt: np.ndarray) -> np.ndarray:
    out = np.zeros(cnt.size + 1, dtype=np.int64)
    np.cumsum(cnt, out=out[1:])
    return out


def _gather_deps(ptr: np.ndarray, order: np.ndarray) -> np.ndarray:
    """Positions of the deps of lanes `order`, lane by lane."""
    cnt = ptr[1:] - ptr[:-1]
    return np.repeat(ptr[:-1][order], cnt[order]) + \
        _segment_arange(cnt[order])


def _flat_lanes(groups, n: int, n_carry: int) -> dict:
    """The groups' real lanes, step-major (within a step: group order, then
    lane order).  A lane that neither finalizes a row nor writes a carry
    (padding) is dropped, and so is a dep slot with coefficient 0.  Each
    lane keeps its 1/diag's flat slot ("dslot") and each dep its
    coefficient's ("slot"); "dropped" lists the real lanes' slots dropped
    as zeros ("coef_slots"/"dinv_slots": the flat sizes)."""
    cols = {k: [] for k in ("step", "row", "cin", "cout", "dinv", "cnt",
                            "idx", "coef", "slot", "dslot", "dropped")}
    off_c = off_d = 0
    for g in groups:
        row = _np(g[0])
        idx, coef, dinv = _np(g[1]), _np(g[2]), _np(g[3])
        C, D = coef.shape[1], coef.shape[2]
        if len(g) == 6:
            cin, cout = _np(g[4]), _np(g[5])
        else:
            cin = np.full(row.shape, n_carry, dtype=np.int64)
            cout = np.full(row.shape, n_carry + 1, dtype=np.int64)
        s_i, c_i = np.nonzero((row != n) | (cout != n_carry + 1))
        keep = coef[s_i, c_i] != 0                      # (lanes, D)
        lane = s_i.astype(np.int64) * C + c_i
        slot = off_c + lane[:, None] * D + np.arange(D)
        cols["slot"].append(slot[keep])
        cols["dropped"].append(slot[~keep])
        cols["dslot"].append(off_d + lane)
        off_c += coef.size
        off_d += dinv.size
        cols["step"].append(s_i)
        cols["row"].append(row[s_i, c_i])
        cols["cin"].append(cin[s_i, c_i])
        cols["cout"].append(cout[s_i, c_i])
        cols["dinv"].append(dinv[s_i, c_i])
        cols["cnt"].append(keep.sum(1))
        cols["idx"].append(idx[s_i, c_i][keep])         # lane-major order
        cols["coef"].append(coef[s_i, c_i][keep])
    cat = {k: (np.concatenate(v) if v else np.zeros(0, dtype=np.int64))
           .astype(np.float32 if k in ("dinv", "coef") else np.int64)
           for k, v in cols.items()}
    order = np.argsort(cat["step"], kind="stable")
    gather = _gather_deps(_ptr(cat["cnt"]), order)
    out = {k: cat[k][order] for k in ("step", "row", "cin", "cout", "dinv",
                                      "cnt", "dslot")}
    for k in ("idx", "coef", "slot"):
        out[k] = cat[k][gather]
    out.update(dropped=cat["dropped"], coef_slots=off_c, dinv_slots=off_d)
    return out


def _fuse_chains(lanes: dict, n: int, n_carry: int) -> dict:
    """Fuse each carry chain (partial lanes linked carry_out -> carry_in)
    into its final lane, which then holds all of the row's deps in chain
    order.  Returns per fused lane: row, dinv and its slot, step (the
    final lane's schedule step), cnt, and the flat idx/coef/slot; lanes
    stay sorted by step."""
    row, step, cin, cout = (lanes[k] for k in ("row", "step", "cin",
                                               "cout"))
    writes = cout != n_carry + 1
    reads = cin != n_carry
    if not (writes.any() or reads.any()):
        return {k: lanes[k] for k in ("row", "dinv", "dslot", "step", "cnt",
                                      "idx", "coef", "slot")}
    if ((cout[writes] < 0) | (cout[writes] >= n_carry)).any() or \
            ((cin[reads] < 0) | (cin[reads] >= n_carry)).any():
        raise ValueError("a carry slot lies outside [0, n_carry)")
    if (writes & (row != n)).any():
        raise ValueError("a lane both finalizes a row and writes a carry")
    n_w = np.bincount(cout[writes], minlength=n_carry)
    n_r = np.bincount(cin[reads], minlength=n_carry)
    for what, cnt in (("writers", n_w), ("readers", n_r)):
        bad = np.flatnonzero(cnt > 1)
        if bad.size:
            raise ValueError(f"carry slot {int(bad[0])} has "
                             f"{int(cnt[bad[0]])} {what}; a chain needs one")
    if (n_w != n_r).any():
        bad = int(np.flatnonzero(n_w != n_r)[0])
        raise ValueError(f"carry slot {bad} is written {int(n_w[bad])} and "
                         f"read {int(n_r[bad])} times")
    reader = np.full(n_carry, -1, dtype=np.int64)
    reader[cin[reads]] = np.flatnonzero(reads)
    nxt = np.arange(row.size, dtype=np.int64)
    nxt[writes] = reader[cout[writes]]
    if (step[nxt[writes]] <= step[writes]).any():
        raise ValueError("a carry slot is read no later than the step that "
                         "writes it")
    while True:                                  # pointer jumping
        jumped = nxt[nxt]
        if np.array_equal(jumped, nxt):
            break
        nxt = jumped
    order = np.lexsort((step, nxt))              # by chain, links in order
    gather = _gather_deps(_ptr(lanes["cnt"]), order)
    finals = np.flatnonzero(~writes)             # sorted: step-major
    fused_cnt = np.bincount(np.searchsorted(finals, nxt[order]),
                            weights=lanes["cnt"][order],
                            minlength=finals.size).astype(np.int64)
    return {"row": row[finals], "dinv": lanes["dinv"][finals],
            "dslot": lanes["dslot"][finals], "step": step[finals],
            "cnt": fused_cnt, "idx": lanes["idx"][gather],
            "coef": lanes["coef"][gather], "slot": lanes["slot"][gather]}


def _relevel(fused: dict, n: int) -> np.ndarray:
    """Each fused lane's DAG level: 0 without deps, else 1 + the latest
    level of the rows it reads.  One vectorised pass per schedule step
    (a lane reads only rows that earlier steps finalize; anything else
    raises)."""
    row, step, cnt, idx = (fused[k] for k in ("row", "step", "cnt", "idx"))
    if row.size and ((row < 0) | (row >= n)).any():
        raise ValueError("a lane finalizes a row outside [0, n)")
    if row.size and np.bincount(row, minlength=n).max() > 1:
        raise ValueError("a row is finalized by more than one lane")
    ptr = _ptr(cnt)
    level_of_row = np.full(n + 1, -1, dtype=np.int64)   # n: never final
    idx_c = np.where((idx >= 0) & (idx < n), idx, n)
    level = np.zeros(row.size, dtype=np.int64)
    bounds = np.concatenate([[0], np.flatnonzero(np.diff(step)) + 1,
                             [row.size]])
    for a, b in zip(bounds[:-1], bounds[1:]):
        ea = ptr[a]
        dep_lvl = level_of_row[idx_c[ea:ptr[b]]]
        if (dep_lvl < 0).any():
            raise ValueError(f"a lane of schedule step {int(step[a])} "
                             "reads a row that no earlier step finalizes")
        nz = np.flatnonzero(cnt[a:b] > 0)
        lvl = np.zeros(b - a, dtype=np.int64)
        if nz.size:
            lvl[nz] = np.maximum.reduceat(dep_lvl, ptr[a:b][nz] - ea) + 1
        level_of_row[row[a:b]] = lvl
        level[a:b] = lvl
    return level


def _cut_tiles(lvl: np.ndarray, nbytes: np.ndarray, narrow: np.ndarray,
               cap: int) -> tuple:
    """Cut the lanes (sorted by step) into tiles of at most `cap` bytes:
    runs of consecutive narrow steps share a tile (a step never straddles
    two of them), a wide step is cut greedily into tiles of its own.
    `narrow` flags each step.  Returns (tile start lanes (T+1,), ends-step
    flags, narrow-run flags)."""
    cum = _ptr(nbytes)
    steps = np.append(np.flatnonzero(np.diff(lvl, prepend=-1) != 0),
                      lvl.size)
    starts, ends_step, runs = [], [], []
    open_run = False
    for k, (a, b) in enumerate(zip(steps[:-1], steps[1:])):
        a, b = int(a), int(b)
        if narrow[k]:
            if not (open_run and cum[b] - cum[starts[-1]] <= cap):
                starts.append(a)
                ends_step.append(True)
                runs.append(True)
            open_run = True
            continue
        open_run = False
        i = a
        while i < b:
            j = min(b, int(np.searchsorted(cum, cum[i] + cap,
                                           side="right")) - 1)
            starts.append(i)
            ends_step.append(j == b)
            runs.append(False)
            i = j
    starts.append(int(lvl.size))
    return (np.asarray(starts, dtype=np.int64),
            np.asarray(ends_step, bool), np.asarray(runs, bool))


def pack_groups(groups, n: int, n_carry: int) -> PackedSchedule:
    """Repack width groups (leaf tuples of numpy arrays or tensors, as in
    `DeviceSchedule.groups`) into the kernel's dependency-exact tiles
    (module doc); the dependency-free rows go to the free pass.  Raises on
    a malformed carry chain (a slot with more than one writer or reader)
    and on a lane that reads a row no earlier step finalizes."""
    PACKS.add("pack_groups")
    t0 = time.perf_counter()
    num_sched_steps = int(_np(groups[0][0]).shape[0]) if groups else 0
    flat = _flat_lanes(groups, n, n_carry)
    fused = _fuse_chains(flat, n, n_carry)
    lvl = _relevel(fused, n)
    row, cnt = fused["row"], fused["cnt"]
    num_steps = int(lvl.max()) + 1 if lvl.size else 0
    widest = int(np.bincount(lvl).max()) if lvl.size else 0
    is_free = lvl == 0
    free = np.flatnonzero(is_free)
    free = free[np.argsort(row[free], kind="stable")]
    long_ = cnt > LONG_DEPS
    tl = np.flatnonzero(~is_free)
    tl = tl[np.lexsort((row[tl], ~long_[tl], lvl[tl]))]
    ptr = _ptr(cnt)
    t_cnt, t_long, t_lvl = cnt[tl], long_[tl], lvl[tl]
    t_far = t_cnt > FAR_DEPS
    t_in = np.where(t_far, 0, t_cnt)                # deps held in the tile
    lane_bytes = 4 * LANE_WORDS + 8 * t_in
    need = 4 * HEADER_WORDS + int(lane_bytes.max(initial=0))
    stage = max(MIN_STAGE_BYTES, -(-need // 1024) * 1024)
    step_lo = np.flatnonzero(np.diff(t_lvl, prepend=-1) != 0)
    step_n = np.diff(np.append(step_lo, t_lvl.size))
    narrow = step_n <= NARROW_LANES
    if step_lo.size:
        narrow &= np.add.reduceat(t_long.astype(np.int64), step_lo) == 0
    starts, ends_step, runs = _cut_tiles(t_lvl, lane_bytes, narrow,
                                         stage - 4 * HEADER_WORDS)
    T = ends_step.size
    tile_nl = np.diff(starts)
    tile_of = np.repeat(np.arange(T), tile_nl)
    lane_in_tile = np.arange(tl.size) - starts[tile_of]
    dcum = _ptr(t_in)
    tile_nd = dcum[starts[1:]] - dcum[starts[:-1]]
    tile_words = -(-(HEADER_WORDS + LANE_WORDS * tile_nl + 2 * tile_nd)
                   // 4) * 4
    base = _ptr(tile_words)
    words = np.zeros(int(base[-1]), dtype=np.int32)
    # header: lanes, long lanes, flags (ends its step | narrow run << 1), 0
    lcum = _ptr(t_long.astype(np.int64))
    tile_long = lcum[starts[1:]] - lcum[starts[:-1]]
    words[base[:-1]] = tile_nl
    words[base[:-1] + 1] = tile_long
    words[base[:-1] + 2] = ends_step | (runs.astype(np.int64) << 1)
    # lane records
    dep_off = HEADER_WORDS + LANE_WORDS * tile_nl[tile_of] + \
        2 * (dcum[:-1] - dcum[starts[tile_of]])
    rec = base[tile_of] + HEADER_WORDS + LANE_WORDS * lane_in_tile
    words[rec] = row[tl]
    words[rec + 1] = fused["dinv"][tl].astype(np.float32).view(np.int32)
    far_first = np.zeros(tl.size, dtype=np.int64)
    far_first[t_far] = _ptr(t_cnt[t_far])[:-1]
    words[rec + 2] = np.where(t_far, ~far_first, dep_off)
    last = np.zeros(tl.size, dtype=np.int64)        # last lane of its step
    last[step_lo[1:] - 1] = 1
    last[-1:] = 1
    words[rec + 3] = (t_cnt | (last << 31)).astype(np.uint32).view(np.int32)
    # deps: (index, coefficient) pairs, in the tile or in `far`
    src = _gather_deps(ptr, tl[~t_far])
    dst = np.repeat((base[tile_of] + dep_off)[~t_far], t_cnt[~t_far]) + \
        2 * _segment_arange(t_cnt[~t_far])
    words[dst] = fused["idx"][src]
    words[dst + 1] = fused["coef"][src].astype(np.float32).view(np.int32)
    tile_word = np.concatenate([dst + 1, rec + 1])
    tile_src = np.concatenate([fused["slot"][src],
                               flat["coef_slots"] + fused["dslot"][tl]])
    src = _gather_deps(ptr, tl[t_far])
    far = np.empty((src.size, 2), dtype=np.int32)
    far[:, 0] = fused["idx"][src]
    far[:, 1] = fused["coef"][src].astype(np.float32).view(np.int32)
    values = ValueMap(
        tile_word=tile_word, tile_src=tile_src,
        far_word=2 * np.arange(src.size, dtype=np.int64) + 1,
        far_src=fused["slot"][src],
        free_src=flat["coef_slots"] + fused["dslot"][free],
        kept=fused["slot"], dropped=flat["dropped"],
        coef_slots=flat["coef_slots"], dinv_slots=flat["dinv_slots"])

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))

    def per_step(vals):             # summed over each step the tiles hold
        return np.bincount(t_lvl, weights=vals.astype(np.float64),
                           minlength=num_steps)[1 if free.size else 0:] \
            .astype(np.int64)

    return PackedSchedule(
        tiles=torch.from_numpy(words), tile_ptr=i32(base // 4),
        far=torch.from_numpy(far.reshape(-1)),
        free_row=i32(row[free]),
        free_dinv=torch.from_numpy(np.ascontiguousarray(
            fused["dinv"][free], dtype=np.float32)),
        n=int(n), n_carry=int(n_carry), num_steps=num_steps,
        schedule_steps=num_sched_steps, stage_bytes=int(stage),
        num_stages=int(min(MAX_STAGES, RING_BYTES // stage)),
        step_short=per_step((~t_long).astype(np.int64)),
        step_long=per_step(t_long * -(-t_cnt // LONG_CHUNK)),
        step_rows=np.bincount(lvl, minlength=num_steps).astype(np.int64),
        step_deps=np.bincount(lvl, weights=cnt.astype(np.float64),
                              minlength=num_steps).astype(np.int64),
        num_lanes=int(row.size), num_deps=int(cnt.sum()),
        long_lanes=int(long_.sum()), widest_step=widest,
        pack_s=time.perf_counter() - t0, values=values)


def schedule_values(sched) -> np.ndarray:
    """A LevelSchedule's flat value buffer, as `ValueMap` indexes it: every
    group's dep_coef raveled in group order, then every group's dinv."""
    return np.concatenate([g.dep_coef.ravel() for g in sched.groups] +
                          [g.dinv.ravel() for g in sched.groups])


def refresh_packed_values(packed: PackedSchedule, sched) -> tuple:
    """The packed form of `sched`, a LevelSchedule with the layout of the
    one `packed` was packed from and new values (`repack_schedule_values`):
    (PackedSchedule, repacked).

    When the coefficients that are 0 (in the schedule's dtype) are the
    ones the packing dropped, the new float32 coefficients and 1/diag are
    scattered through `packed.values` into clones of `tiles` and `far` and
    a new `free_dinv`, on `packed`'s device (CPU tensors take the same
    torch ops); everything else is shared.  Otherwise the dependency DAG
    the packing re-levelled has changed, and `sched` is packed anew
    (`repacked` True).  `packed`'s own tensors are never written."""
    vm = packed.values
    if vm is None:
        raise ValueError("the packed schedule carries no value map; pack it "
                         "with pack_groups")
    vals = schedule_values(sched)
    if vals.size != vm.coef_slots + vm.dinv_slots:
        raise ValueError(f"the schedule holds {vals.size} value slots, the "
                         f"packed one was packed from "
                         f"{vm.coef_slots + vm.dinv_slots}")
    dev = packed.tiles.device
    coef = vals[:vm.coef_slots]
    if (coef[vm.kept] == 0).any() or (coef[vm.dropped] != 0).any():
        PACKS.add("repacks")
        return pack_schedule(sched).to(dev), True
    tile_word, tile_src, far_word, far_src, free_src = vm.staged(dev)
    v = torch.from_numpy(np.asarray(vals, dtype=np.float32)).to(dev)
    tiles, far = packed.tiles.clone(), packed.far.clone()
    tiles.view(torch.float32).index_copy_(0, tile_word, v[tile_src])
    far.view(torch.float32).index_copy_(0, far_word, v[far_src])
    PACKS.add("refreshes")
    return dataclasses.replace(packed, tiles=tiles, far=far,
                               free_dinv=v[free_src]), False


def pack_schedule(sched) -> PackedSchedule:
    """`pack_groups` over a host LevelSchedule's width groups."""
    leaves = tuple(
        (g.row_ids, g.dep_idx, g.dep_coef, g.dinv) +
        ((g.carry_in, g.carry_out) if g.carry_in is not None else ())
        for g in sched.groups)
    return pack_groups(leaves, sched.n, sched.n_carry)


def step_flops(rows, deps):
    """Operations of a step: an FMA per dep, a multiply per row (the
    reference profiler's real flops, 2 x deps + finalized rows)."""
    return 2 * np.asarray(deps, dtype=np.int64) + \
        np.asarray(rows, dtype=np.int64)


def step_bytes(rows, deps):
    """Bytes a step needs: per row its index, 1/diag, c read and x
    written; per dep its index and coefficient (float32)."""
    return 16.0 * np.asarray(rows, dtype=np.float64) + \
        8.0 * np.asarray(deps, dtype=np.float64)


def unpack_tiles(packed: PackedSchedule) -> dict:
    """Decode the tile stream into per-lane numpy arrays, lane by lane in
    stream order: tile, step (counting the free pass as step 0 when it
    exists), row, dinv, long (summed by a warp), last (of its step),
    dep_ptr, dep_idx, dep_coef; plus the per-tile header fields under
    "tile_*"."""
    w = _np(packed.tiles)
    wf = np.concatenate([w, _np(packed.far)])   # tiles, then far pairs
    tp = _np(packed.tile_ptr).astype(np.int64) * 4
    out = {k: [] for k in ("tile", "step", "row", "dinv", "long", "last",
                           "dep_cnt", "dep_idx", "dep_coef")}
    hdr = {k: [] for k in ("lanes", "long", "ends_step", "narrow_run")}
    step = 1 if packed.num_free else 0
    for t in range(packed.num_tiles):
        tw = w[tp[t]:tp[t + 1]]
        nl, nlong, flags = (int(v) for v in tw[:3])
        for k, v in zip(hdr, (nl, nlong, bool(flags & 1),
                              bool(flags & 2))):
            hdr[k].append(v)
        rec = tw[HEADER_WORDS:HEADER_WORDS + LANE_WORDS * nl].reshape(
            nl, LANE_WORDS)
        cnt = (rec[:, 3] & 0x7FFFFFFF).astype(np.int64)
        last = rec[:, 3] < 0
        off = rec[:, 2].astype(np.int64)        # < 0: ~(pair in far)
        off = np.where(off < 0, w.size + 2 * ~off, tp[t] + off)
        pos = np.repeat(off, cnt) + 2 * _segment_arange(cnt)
        out["tile"].append(np.full(nl, t))
        out["step"].append(step + np.cumsum(last) - last)
        out["row"].append(rec[:, 0])
        out["dinv"].append(np.ascontiguousarray(rec[:, 1]).view(np.float32))
        out["long"].append(np.arange(nl) < nlong)
        out["last"].append(last)
        out["dep_cnt"].append(cnt)
        out["dep_idx"].append(wf[pos])
        out["dep_coef"].append(wf[pos + 1].view(np.float32))
        step += int(last.sum())
    empty = {"dinv": np.float32, "dep_coef": np.float32, "long": bool,
             "last": bool}
    res = {k: (np.concatenate(v) if v else
               np.zeros(0, dtype=empty.get(k, np.int64)))
           for k, v in out.items()}
    res["dep_ptr"] = _ptr(res.pop("dep_cnt").astype(np.int64))
    res.update({f"tile_{k}": np.asarray(v) for k, v in hdr.items()})
    return res


def emulate_packed(packed: PackedSchedule, c_pad: torch.Tensor) \
        -> torch.Tensor:
    """The kernel's loop in torch on the packed arrays: the free pass, then
    tile by tile and, inside a tile, step by step, a step's writes becoming
    visible only after its last lane (the kernel's step barrier, or warp
    0's __syncwarp in a narrow run).  c_pad (n+1,) or (n+1, R) float32.
    Returns x (n,) or (n, R)."""
    n = packed.n
    tail = tuple(c_pad.shape[1:])
    dev = c_pad.device
    x = torch.zeros((n + 1,) + tail, dtype=c_pad.dtype, device=dev)

    def col(a):
        t = torch.as_tensor(a, device=dev)
        return t.to(c_pad.dtype)[:, None] if tail else t.to(c_pad.dtype)

    fr = packed.free_row.to(dev).long()
    x[fr] = c_pad[fr] * col(packed.free_dinv)
    lanes = unpack_tiles(packed)
    dptr = lanes["dep_ptr"]
    # segments: the lanes of one step inside one tile
    cut = np.flatnonzero(lanes["last"] |
                         np.append(np.diff(lanes["tile"]) != 0, True)) + 1
    pending = []
    for a, b in zip(np.concatenate([[0], cut[:-1]]), cut):
        idx = torch.as_tensor(lanes["dep_idx"][dptr[a]:dptr[b]],
                              device=dev).long()
        owner = torch.as_tensor(np.repeat(np.arange(b - a), np.diff(
            dptr[a:b + 1])), device=dev)
        tot = torch.zeros((b - a,) + tail, dtype=c_pad.dtype, device=dev)
        tot.index_add_(0, owner, col(lanes["dep_coef"][dptr[a]:dptr[b]])
                       * x[idx])
        row = torch.as_tensor(lanes["row"][a:b], device=dev).long()
        pending.append((row, (c_pad[row] - tot) * col(lanes["dinv"][a:b])))
        if lanes["last"][b - 1]:
            for r, v in pending:
                x[r] = v
            pending = []
    return x[:n]


def items_per_lane(R: int) -> int:
    """A short lane's items, a consumer thread's unit of work: one per
    column, or at R % 4 == 0 (R > 1) one per 4 columns (float4 gathers)."""
    return R // 4 if R > 1 and R % 4 == 0 else R


def consumer_terms(packed: PackedSchedule, R: int) -> tuple:
    """The two terms of the block size's cost for R columns, per count of
    consumer warps w = 1..MAX_CONSUMERS // 32: (w, the warps' bookkeeping
    w x wide steps, the extra rounds: items or long-lane gathers past a
    thread's or a warp's first, summed over the wide steps).  Narrow runs
    go to warp 0 whatever the count."""
    items, longs = packed.step_short * items_per_lane(R), packed.step_long
    wide = (packed.step_short > NARROW_LANES) | (longs > 0)
    warps = np.arange(1, MAX_CONSUMERS // 32 + 1)
    rounds = np.maximum(-(-items[wide] // (32 * warps[:, None])), 1) + \
        np.maximum(-(-longs[wide] // warps[:, None]), 1) - 2
    return warps, warps * int(wide.sum()), rounds.sum(1)


def consumer_threads(packed: PackedSchedule, R: int) -> int:
    """Consumer threads for R columns: 32 x the warps that minimize
    bookkeeping + ROUND_WARPS x extra rounds (`consumer_terms`).  Cached
    per R in `packed.consumers`."""
    got = packed.consumers.get(R)
    if got is None:
        warps, book, rounds = consumer_terms(packed, R)
        got = packed.consumers[R] = \
            32 * int(warps[np.argmin(book + ROUND_WARPS * rounds)])
    return got


def _check_launch(packed: PackedSchedule, c_pad: torch.Tensor) -> None:
    """What the CUDA kernels take: c_pad (n+1, R) float32, contiguous, and
    the packed schedule contiguous on c_pad's device."""
    if c_pad.dtype != torch.float32:
        raise TypeError(f"the CUDA SpTRSV kernel takes float32, got "
                        f"{c_pad.dtype}")
    if c_pad.ndim != 2 or c_pad.shape[0] != packed.n + 1:
        raise ValueError(f"c_pad must be ({packed.n + 1}, R), got "
                         f"{tuple(c_pad.shape)}")
    if not c_pad.is_contiguous():
        raise ValueError("c_pad must be contiguous")
    for t in packed.tensors():
        if t.device != c_pad.device or not t.is_contiguous():
            raise ValueError(f"packed schedule must be contiguous on "
                             f"{c_pad.device}, got a tensor on {t.device}")


def _launch(packed: PackedSchedule, c_pad: torch.Tensor) -> torch.Tensor:
    """Check and launch the CUDA kernels on c_pad (n+1, R) float32."""
    _check_launch(packed, c_pad)
    dev = c_pad.device
    R = int(c_pad.shape[1])
    if items_per_lane(R) != R and c_pad.data_ptr() % 16:
        c_pad = c_pad.clone()           # float4 gathers need 16-byte rows
    x = torch.zeros((packed.n + 1, R), dtype=torch.float32, device=dev)
    consumers = consumer_threads(packed, R)
    fn = _entry("sptrsv_tiles_launch")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(packed.tiles.data_ptr(), packed.tile_ptr.data_ptr(),
                 packed.num_tiles, packed.far.data_ptr(),
                 packed.free_row.data_ptr(),
                 packed.free_dinv.data_ptr(), packed.num_free,
                 c_pad.data_ptr(), x.data_ptr(), R, consumers + 32,
                 packed.stage_bytes, packed.num_stages, stream)
    if err != 0:
        raise RuntimeError(
            f"sptrsv_tiles_kernel launch failed: CUDA error {err} (threads="
            f"{consumers + 32}, tiles={packed.num_tiles}, stage_bytes="
            f"{packed.stage_bytes} x {packed.num_stages}, R={R})")
    return x


def _kernel_solve(groups, c_pad: torch.Tensor, n: int, n_carry: int,
                  packed: PackedSchedule | None, key: str) -> torch.Tensor:
    """Launch the kernel for c_pad (n+1, R) on CUDA and count the launch
    under `key`, the entry point that made it.  `packed` is the schedule's
    packed form on c_pad's device; `groups` is packed here when it is None.
    """
    if packed is None:
        if groups is None:
            raise ValueError("pass the width groups or their packed form")
        packed = pack_groups(groups, n, n_carry).to(c_pad.device)
    if packed.n != n or packed.n_carry != n_carry:
        raise ValueError(f"packed schedule is for n={packed.n}, n_carry="
                         f"{packed.n_carry}, not n={n}, n_carry={n_carry}")
    x = _launch(packed, c_pad)
    LAUNCHES.add(key)
    return x[:n]


def _plain(groups, c_pad: torch.Tensor, n: int, n_carry: int) \
        -> torch.Tensor:
    if groups is None:
        raise ValueError("the plain version needs the width groups")
    LAUNCHES.add("plain")
    return ref.sptrsv_levels_grouped_ref(groups, c_pad, n, n_carry)


def sptrsv_groups(groups, c_pad: torch.Tensor, *, n: int, n_carry: int,
                  packed: PackedSchedule | None = None) -> torch.Tensor:
    """K1: solve a width-bucketed schedule for c_pad (n+1,); returns x (n,).

    `groups` as in `DeviceSchedule.groups`; `packed` is its packed form on
    c_pad's device (packed here when None; with it, `groups` may be None
    on CUDA).  CPU tensors take the plain version; CUDA tensors launch the
    kernel.
    """
    if c_pad.ndim != 1:
        raise ValueError(f"sptrsv_groups takes c_pad (n+1,), got "
                         f"{tuple(c_pad.shape)}; use sptrsv_groups_multi")
    if c_pad.device.type == "cpu":
        return _plain(groups, c_pad, n, n_carry)
    return _kernel_solve(groups, c_pad.reshape(-1, 1), n, n_carry, packed,
                         "sptrsv_groups")[:, 0]


def sptrsv_groups_multi(groups, c_pad: torch.Tensor, *, n: int,
                        n_carry: int,
                        packed: PackedSchedule | None = None) -> torch.Tensor:
    """K2: the same solve for c_pad (n+1, R); returns x (n, R).  The
    schedule streams once for all R columns (one thread per short lane and
    column, one warp per long lane looping over the columns)."""
    if c_pad.ndim != 2:
        raise ValueError(f"sptrsv_groups_multi takes c_pad (n+1, R), got "
                         f"{tuple(c_pad.shape)}")
    if c_pad.device.type == "cpu":
        return _plain(groups, c_pad, n, n_carry)
    return _kernel_solve(groups, c_pad, n, n_carry, packed,
                         "sptrsv_groups_multi")


@dataclasses.dataclass
class StampedSolve:
    """What K1's stamped form returns: x (n,), and on the card the tile
    kernel's clock64() stamps (num_steps - 1 + 2 int64 when the free pass
    holds step 0: the kernel's entry, the consumers' start, then the end of
    each tile step) with CUDA events around the free pass and around the
    tile kernel.  On the CPU (the plain version) stamps and events are None.
    """

    x: torch.Tensor
    stamps: torch.Tensor | None = None
    free_events: tuple | None = None
    tile_events: tuple | None = None

    def event_ms(self) -> tuple:
        """(free pass ms, tile kernel ms) by events; synchronizes.  A pass
        that was not launched reads 0.0."""
        out = []
        for ev in (self.free_events, self.tile_events):
            if ev is None:
                out.append(0.0)
            else:
                ev[1].synchronize()
                out.append(float(ev[0].elapsed_time(ev[1])))
        return tuple(out)


def _stamped_launch(packed: PackedSchedule, c_pad: torch.Tensor) \
        -> StampedSolve:
    """The free pass and the stamped tile kernel on c_pad (n+1, 1), each
    between two CUDA events on the current stream."""
    _check_launch(packed, c_pad)
    dev = c_pad.device
    x = torch.zeros((packed.n + 1, 1), dtype=torch.float32, device=dev)
    tile_steps = packed.num_steps - (1 if packed.num_free else 0)
    stamps = torch.zeros(tile_steps + 2, dtype=torch.int64, device=dev)
    consumers = consumer_threads(packed, 1)
    free_fn = _entry("sptrsv_free_launch")
    tile_fn = _entry("sptrsv_tiles_stamped_launch")
    out = StampedSolve(x=x, stamps=stamps)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream

        def timed(launch):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            err = launch()
            ev[1].record()
            if err != 0:
                raise RuntimeError(
                    f"stamped sptrsv launch failed: CUDA error {err} "
                    f"(threads={consumers + 32}, tiles={packed.num_tiles}, "
                    f"stage_bytes={packed.stage_bytes} x "
                    f"{packed.num_stages})")
            return ev

        if packed.num_free:
            out.free_events = timed(lambda: free_fn(
                packed.free_row.data_ptr(), packed.free_dinv.data_ptr(),
                packed.num_free, c_pad.data_ptr(), x.data_ptr(), stream))
        if packed.num_tiles:
            out.tile_events = timed(lambda: tile_fn(
                packed.tiles.data_ptr(), packed.tile_ptr.data_ptr(),
                packed.num_tiles, packed.far.data_ptr(), c_pad.data_ptr(),
                x.data_ptr(), consumers + 32, packed.stage_bytes,
                packed.num_stages, stamps.data_ptr(), stream))
    return out


def sptrsv_groups_stamped(groups, c_pad: torch.Tensor, *, n: int,
                          n_carry: int,
                          packed: PackedSchedule | None = None) \
        -> StampedSolve:
    """K1's stamped form: the solve of `sptrsv_groups` for c_pad (n+1,),
    with the end of every tile step stamped by clock64() on the card
    (`StampedSolve`).  The serving kernel is compiled without the stamps.
    CPU tensors take the plain version and carry no stamps."""
    if c_pad.ndim != 1:
        raise ValueError(f"sptrsv_groups_stamped takes c_pad (n+1,), got "
                         f"{tuple(c_pad.shape)}")
    if c_pad.device.type == "cpu":
        return StampedSolve(x=_plain(groups, c_pad, n, n_carry))
    if packed is None:
        if groups is None:
            raise ValueError("pass the width groups or their packed form")
        packed = pack_groups(groups, n, n_carry).to(c_pad.device)
    if packed.n != n or packed.n_carry != n_carry:
        raise ValueError(f"packed schedule is for n={packed.n}, n_carry="
                         f"{packed.n_carry}, not n={n}, n_carry={n_carry}")
    out = _stamped_launch(packed, c_pad.reshape(-1, 1).contiguous())
    LAUNCHES.add("sptrsv_groups_stamped")
    out.x = out.x[:n, 0]
    return out


_LEGACY_PACKED = collections.OrderedDict()   # key -> (array refs, packed)
_LEGACY_KEEP = 8


def _legacy_packed(groups, n: int, n_carry: int,
                   device) -> PackedSchedule:
    """K3's packed form of its flat arrays on `device`: the one packed for
    the same tensor objects at the same versions (no in-place write since;
    among the last _LEGACY_KEEP), else packed now."""
    arrays = groups[0]
    if not all(isinstance(a, torch.Tensor) for a in arrays):
        return pack_groups(groups, n, n_carry).to(device)
    key = (n, n_carry, str(device)) + tuple((id(a), a._version)
                                            for a in arrays)
    hit = _LEGACY_PACKED.pop(key, None)
    if hit is not None and all(r() is a for r, a in zip(hit[0], arrays)):
        packed = hit[1]
    else:
        packed = pack_groups(groups, n, n_carry).to(device)
    _LEGACY_PACKED[key] = (tuple(weakref.ref(a) for a in arrays), packed)
    while len(_LEGACY_PACKED) > _LEGACY_KEEP:
        _LEGACY_PACKED.popitem(last=False)
    return packed


def sptrsv_levels(row_ids, dep_idx, dep_coef, dinv, carry_in, carry_out,
                  c_ids, c_pad: torch.Tensor, *, n: int,
                  n_carry: int) -> torch.Tensor:
    """K3: single-group compatibility wrapper over K1's kernel (legacy flat
    signature; c_ids is accepted and ignored — row_ids doubles as the c
    gather index).  Its arrays are packed like any schedule's, carry
    chains fused; a repeated call with the same tensors, unchanged, finds
    their packed form kept.  Its launches count under "sptrsv_levels"
    only."""
    del c_ids
    if c_pad.ndim != 1:
        raise ValueError(f"sptrsv_levels takes c_pad (n+1,), got "
                         f"{tuple(c_pad.shape)}")
    groups = ((row_ids, dep_idx, dep_coef, dinv, carry_in, carry_out),)
    if c_pad.device.type == "cpu":
        return _plain(groups, c_pad, n, n_carry)
    return _kernel_solve(None, c_pad.reshape(-1, 1), n, n_carry,
                         _legacy_packed(groups, n, n_carry, c_pad.device),
                         "sptrsv_levels")[:, 0]
