"""Per-step schedule profiler: where does a sweep's time go?

Port of `repro.obs.profile` (`ScheduleProfile`, `profile_schedule`,
`profile_operator`).  It is the measurement the tuner's cost constants
come from: `CostModel.calibrate(profile)` (repro_torch.core.portfolio)
fits them to one.  Two engines, two methods:

* **"torch" (the plain engine, on the CPU).**  As the reference does: the
  schedule runs ONE STEP AT A TIME through the plain step body
  (`levelset._step_body`), and each step's wall time is kept, the minimum
  over reps.  The step columns are the schedule's: padded and real FLOPs
  of its width groups, and its bytes spread evenly over the steps.
* **"cuda" (the card).**  Timing steps one launch at a time would measure
  the launch (microseconds) instead of the step (K1 runs one in under a
  microsecond inside one launch).  So one launch of K1's stamped form
  (`kernels.sptrsv_level.sptrsv_groups_stamped`) fills `step_ms`: the
  kernel stamps clock64() at the end of every packed step, and the cycles
  become time at the launch's own rate, its CUDA-event time over its
  cycles from entry to the last step.  The free first-level pass is its
  own launch, timed by events, and is step 0.  The step columns describe
  the packed steps: their rows and deps (`step_flops`, `step_bytes`);
  the free pass's are zero, since it runs on every SM and its cost is its
  launch (`CudaEngine.sweep_shape` charges it so).
  The profile also measures the host's time per launch (`launch_us`: the
  time to enqueue a served solve, the card running behind, over its
  launches), which `calibrate` turns into the per-launch charge.
* **"sharded" (a mesh, on its device).**  As the reference does: the
  padded schedule runs one step at a time through the sharded step body
  (`distributed._step_update`) on this rank's lane block, each step
  synchronized (the card's stream too) and timed, twice: a "full" pass
  with the per-step all_gather family, and a "compute" pass whose gather
  is the identity (the same per-step work, no collective; its x is
  discarded).  `collective_ms` is their difference per step, which
  `calibrate` turns into `collective_latency_us`.  Every rank of the
  mesh must profile together (the full pass runs the collectives).

`ProfilingEngine` wraps an engine with this loop behind the standard
Engine protocol (opt-in: a measurement tool, not a serving path), exposing
`last_profile` after each solve: with no base engine it steps through the
plain torch loop; over the "cuda" engine every solve it serves is one run
of K1's stamped form; over a ShardedEngine it routes the engine's mesh and
axis through (the collective split).  `profile_operator` does the same for
an operator whose engine is sharded.

Clocks are injected (`clock=time.perf_counter` by default) for both
methods: the CPU's step times and the card's host time per launch.  The
step-wise loop has the reference's `_STEP_FAULT` seam, which
`core.faults.slow_step` sets to stall one step of every timed pass; the
stamped form is one launch, so no host stall can land inside one of its
steps.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .metrics import DEFAULT_MS_BUCKETS

__all__ = ["ScheduleProfile", "profile_schedule", "profile_operator",
           "merge_profiles", "ProfilingEngine", "DEFAULT_MS_BUCKETS"]

# (step_idx, seconds) | None — patched by core.faults.slow_step to stall
# one step of every *timed* pass of the step-wise loop (warm-up runs stay
# clean)
_STEP_FAULT = None


def _fire_step_fault(s: int) -> None:
    f = _STEP_FAULT
    if f is not None and f[0] == s:
        time.sleep(f[1])


@dataclasses.dataclass
class ScheduleProfile:
    """One profiled execution of a schedule (module doc).

    `step_ms` is min-over-reps per step; `collective_ms` is the per-step
    collective share on the sharded path (None elsewhere); the flop/byte
    columns are the steps the engine executed.  On the card: `launch_us`
    is the host's time per launch, `event_ms` the stamped tile kernel's
    event time, `stamped_ms` the sum of its steps' stamps, `clock_mhz` the
    rate its cycles ran at (all None on the CPU).
    """

    engine: str
    num_steps: int
    reps: int
    step_ms: np.ndarray
    collective_ms: np.ndarray | None
    step_padded_flops: np.ndarray
    step_real_flops: np.ndarray
    step_bytes: np.ndarray
    width_buckets: list
    launch_us: float | None = None
    event_ms: float | None = None
    stamped_ms: float | None = None
    clock_mhz: float | None = None

    @property
    def compute_ms(self):
        """Per-step compute component (collective subtracted, clamped at
        0); None when the profile has no collective split."""
        if self.collective_ms is None:
            return None
        return np.maximum(self.step_ms - self.collective_ms, 0.0)

    def total_ms(self) -> float:
        return float(self.step_ms.sum())

    def critical_path_share(self) -> float:
        """Share of total time the serialized step floor (S x fastest
        step) accounts for: 1.0 = perfectly uniform steps, low values =
        a few straggler steps dominate."""
        tot = float(self.step_ms.sum())
        if not self.num_steps or tot <= 0:
            return float("nan")
        return float(self.num_steps * self.step_ms.min() / tot)

    def utilization(self) -> float:
        """Real / padded FLOPs over the whole schedule."""
        p = sum(b["padded_flops"] for b in self.width_buckets)
        r = sum(b["real_flops"] for b in self.width_buckets)
        return r / p if p else 0.0

    def slowest_steps(self, k: int = 5) -> list:
        order = np.argsort(self.step_ms, kind="stable")[::-1]
        return [int(i) for i in order[:k]]

    def step_histogram(self, bounds=DEFAULT_MS_BUCKETS) -> dict:
        """Step-time histogram over fixed upper-inclusive bounds (ms);
        the final count is the +Inf overflow."""
        counts = [0] * (len(bounds) + 1)
        for v in self.step_ms:
            i = len(bounds)
            for j, b in enumerate(bounds):
                if v <= b:
                    i = j
                    break
            counts[i] += 1
        return {"bounds": list(bounds), "counts": counts}

    def to_dict(self) -> dict:
        return {
            "engine": self.engine, "num_steps": self.num_steps,
            "reps": self.reps,
            "total_ms": self.total_ms(),
            "critical_path_share": self.critical_path_share(),
            "utilization": self.utilization(),
            "step_ms": [float(v) for v in self.step_ms],
            "collective_ms": (None if self.collective_ms is None else
                              [float(v) for v in self.collective_ms]),
            "step_padded_flops": [int(v) for v in self.step_padded_flops],
            "step_real_flops": [int(v) for v in self.step_real_flops],
            "step_bytes": [float(v) for v in self.step_bytes],
            "width_buckets": list(self.width_buckets),
            "step_histogram": self.step_histogram(),
            "slowest_steps": self.slowest_steps(),
            "launch_us": self.launch_us, "event_ms": self.event_ms,
            "stamped_ms": self.stamped_ms, "clock_mhz": self.clock_mhz,
        }


def merge_profiles(profiles) -> ScheduleProfile:
    """One profile whose steps are all of `profiles`' steps, in order, so
    that `calibrate` fits one set of constants to several schedules;
    `launch_us` is the median of theirs (None when none has one), and the
    collective split is kept when every profile has one."""
    profiles = list(profiles)
    if not profiles:
        raise ValueError("no profile to merge")

    def cat(name):
        return np.concatenate([np.asarray(getattr(p, name))
                               for p in profiles])

    launch = [p.launch_us for p in profiles if p.launch_us is not None]
    return ScheduleProfile(
        engine="+".join(sorted({p.engine for p in profiles})),
        num_steps=sum(p.num_steps for p in profiles),
        reps=min(p.reps for p in profiles), step_ms=cat("step_ms"),
        collective_ms=(cat("collective_ms") if all(
            p.collective_ms is not None for p in profiles) else None),
        step_padded_flops=cat("step_padded_flops"),
        step_real_flops=cat("step_real_flops"), step_bytes=cat("step_bytes"),
        width_buckets=[b for p in profiles for b in p.width_buckets],
        launch_us=float(np.median(launch)) if launch else None)


def _schedule_columns(sched):
    """(per-step padded flops, per-step real flops, per-step bytes,
    width buckets) for the schedule as executed."""
    S = sched.num_steps
    ppf = 0
    rf = np.zeros(S, dtype=np.int64)
    buckets = []
    for g in sched.groups:
        s_, c_, d_ = g.dep_idx.shape
        padded = 2 * s_ * c_ * d_ + s_ * c_
        real = int(2 * (g.dep_coef != 0).sum() + g.is_final.sum())
        ppf += 2 * c_ * d_ + c_
        rf += (2 * (g.dep_coef != 0).sum(axis=(1, 2))
               + g.is_final.sum(axis=1))
        buckets.append({
            "width": int(g.width), "lanes": int(c_),
            "padded_flops": int(padded), "real_flops": real,
            "utilization": real / padded if padded else 0.0})
    pf = np.full(S, ppf, dtype=np.int64)
    sb = np.full(S, sched.memory_bytes() / max(1, S), dtype=np.float64)
    return pf, rf, sb, buckets


def _profile_stepwise(ds, c: torch.Tensor, *, reps, warmup, clock):
    """The plain engine, one step at a time: (ScheduleProfile, x)."""
    from ..solver.levelset import _step_body, pad_rhs
    host = ds.host
    groups = ds.groups
    S = host.num_steps
    n, n_carry = ds.n, ds.n_carry
    c_pad = pad_rhs(c)
    tail = tuple(c_pad.shape[1:])
    per_step = [tuple(tuple(l[s] for l in g) for g in groups)
                for s in range(S)]

    def run(record):
        x = torch.zeros((n + 1,) + tail, dtype=c_pad.dtype,
                        device=c_pad.device)
        carry = torch.zeros((n_carry + 2,) + tail, dtype=c_pad.dtype,
                            device=c_pad.device)
        for s, sg in enumerate(per_step):
            t0 = clock()
            if record is not None:
                _fire_step_fault(s)     # stall INSIDE the timed window
            _step_body(x, carry, c_pad, sg)
            if record is not None:
                record[s] = min(record[s], clock() - t0)
        return x[:n]

    for _ in range(max(0, warmup)):
        run(None)
    rec = np.full(S, np.inf)
    x = None
    for _ in range(max(1, reps)):
        x = run(rec)
    step_ms = np.where(np.isfinite(rec), rec, 0.0) * 1e3
    pf, rf, sb, buckets = _schedule_columns(host)
    prof = ScheduleProfile(
        engine="stepwise", num_steps=S, reps=max(1, reps), step_ms=step_ms,
        collective_ms=None, step_padded_flops=pf, step_real_flops=rf,
        step_bytes=sb, width_buckets=buckets)
    return prof, x


def _profile_stamped(ds, c: torch.Tensor, *, reps, warmup, engine, clock):
    """K1's stamped form on the card: (ScheduleProfile, x)."""
    from ..kernels import sptrsv_level as K
    from ..solver.levelset import pad_rhs
    if c.ndim != 1:
        raise ValueError(f"the stamped profile takes c (n,), got "
                         f"{tuple(c.shape)}")
    packed = ds.packed()
    c_pad = pad_rhs(c.to(torch.float32)).contiguous()

    def stamped():
        return K.sptrsv_groups_stamped(None, c_pad, n=ds.n,
                                       n_carry=ds.n_carry, packed=packed)

    # the solves go out back to back, one warm-up at least ahead of the
    # timed ones: each timed launch's events are recorded while the card
    # is still busy, so they time the kernels and not the host's gaps
    # between an event and its launch
    runs = [stamped() for _ in range(max(1, warmup) + max(1, reps))]
    torch.cuda.synchronize(c_pad.device)
    S = packed.num_steps
    rec = np.full(S, np.inf)
    event_ms, stamped_ms, mhz, x = np.inf, 0.0, 0.0, None
    for run in runs[max(1, warmup):]:
        free_ms, tile_ms = run.event_ms()
        st = run.stamps.cpu().numpy().astype(np.int64)
        cycles = int(st[-1] - st[0])        # the kernel's entry to its end
        ms_per_cycle = tile_ms / cycles if cycles > 0 else 0.0
        spans = np.diff(st[1:]) * ms_per_cycle
        steps = np.concatenate([[free_ms], spans]) if packed.num_free \
            else spans
        if steps.size != S or (spans < 0).any():
            raise RuntimeError(f"the stamped kernel wrote {spans.size} "
                               f"step spans for {S} steps, or a negative "
                               "one: its stamps are out of order")
        rec = np.minimum(rec, steps)
        if tile_ms < event_ms:
            event_ms, x = tile_ms, run.x
            stamped_ms = float(spans.sum())
            mhz = cycles / tile_ms / 1e3 if tile_ms > 0 else 0.0
    launch_us = _launch_us(engine.compile(ds), c, packed.launches,
                           clock=clock)
    rows, deps = packed.step_rows.copy(), packed.step_deps.copy()
    if packed.num_free:
        rows[0] = deps[0] = 0   # the free pass: a launch, not rows
    flops = K.step_flops(rows, deps)
    prof = ScheduleProfile(
        engine="cuda", num_steps=S, reps=max(1, reps), step_ms=rec,
        collective_ms=None, step_padded_flops=flops, step_real_flops=flops,
        step_bytes=K.step_bytes(rows, deps),
        width_buckets=[{"width": int(packed.widest_step),
                        "lanes": int(packed.num_lanes),
                        "padded_flops": int(flops.sum()),
                        "real_flops": int(flops.sum()),
                        "utilization": 1.0}],
        launch_us=launch_us, event_ms=float(event_ms),
        stamped_ms=stamped_ms, clock_mhz=float(mhz))
    return prof, x


def _profile_sharded(host, c, mesh, axis: str, *, reps, warmup, clock):
    """The sharded path, one step at a time, with and without its
    collectives: (ScheduleProfile, x)."""
    from ..solver import distributed as D
    from ..solver.levelset import pad_rhs, torch_dtype
    group, nshards, rank = D.axis_group(mesh, axis)
    device = D.mesh_device(mesh)
    padded = D._padded_schedule(host, nshards)
    per_step = D._per_step(D._stage_block(padded, rank, nshards, device),
                           padded.num_steps)
    ct = torch.as_tensor(np.asarray(c) if not isinstance(c, torch.Tensor)
                         else c, device=device).to(torch_dtype(host.dtype))
    c_pad = pad_rhs(ct)
    S, n, n_carry = padded.num_steps, padded.n, padded.n_carry

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def run(record, gather):
        x, carry = D._init_state(n, n_carry, c_pad)
        for s, sg in enumerate(per_step):
            t0 = clock()
            if record is not None:
                _fire_step_fault(s)     # stall INSIDE the timed window
            x, carry = D._step_update(x, carry, c_pad, sg, n_carry=n_carry,
                                      group=group, gather=gather)
            sync()
            if record is not None:
                record[s] = min(record[s], clock() - t0)
        return x[:n]

    # the identity-gather pass keeps each rank's updates local: the same
    # per-step work, no collective, unusable numerics — timed, discarded
    timings, x = {}, None
    for kind, gather in (("full", D._gather),
                         ("compute", lambda v, group: v)):
        for _ in range(max(0, warmup)):
            run(None, gather)
        rec = np.full(S, np.inf)
        for _ in range(max(1, reps)):
            out = run(rec, gather)
            if kind == "full":
                x = out
        timings[kind] = np.where(np.isfinite(rec), rec, 0.0) * 1e3
    pf, rf, sb, buckets = _schedule_columns(padded)
    prof = ScheduleProfile(
        engine="sharded", num_steps=S, reps=max(1, reps),
        step_ms=timings["full"],
        collective_ms=np.maximum(timings["full"] - timings["compute"], 0.0),
        step_padded_flops=pf, step_real_flops=rf, step_bytes=sb,
        width_buckets=buckets)
    return prof, x


def _launch_us(fn, c: torch.Tensor, launches: int, calls: int = 20,
               clock=time.perf_counter) -> float:
    """Host time per launch of the served solve `fn(c)`: the host's time
    (by `clock`, in seconds) to enqueue `calls` calls back to back (the
    card runs behind it, so no call waits for the device), per call, over
    the call's launches."""
    fn(c)
    torch.cuda.synchronize(c.device)
    t0 = clock()
    for _ in range(calls):
        fn(c)
    host = (clock() - t0) / calls
    torch.cuda.synchronize(c.device)
    return host * 1e6 / max(1, launches)


def profile_schedule(sched, c, *, reps: int = 2, warmup: int = 1,
                     clock=time.perf_counter, device=None,
                     engine=None, mesh=None,
                     axis: str = "model") -> ScheduleProfile:
    """Profile one schedule execution per step (module doc).

    sched: a LevelSchedule or DeviceSchedule; c: the preamble-applied
    right-hand side (n,) (numpy or tensor; (n, k) on the CPU and under a
    mesh).  device: where to run ("cuda" when None, as every entry point
    of the port; a DeviceSchedule's own device wins); engine: "torch"
    profiles step by step, "cuda" by K1's stamps (None: the device's
    default).  `mesh` (a DeviceMesh and its `axis`), or a ShardedEngine as
    `engine`, profiles the sharded path on the mesh's device and splits
    each step into collective and compute time.
    """
    return _profile_and_solve(sched, c, reps=reps, warmup=warmup,
                              clock=clock, device=device, engine=engine,
                              mesh=mesh, axis=axis)[0]


def _profile_and_solve(sched, c, *, reps, warmup, clock, device, engine,
                       mesh=None, axis="model"):
    from ..solver.engines import resolve_engine
    from ..solver.levelset import (DeviceSchedule, resolve_device,
                                   to_device, torch_dtype)
    if engine is not None:
        engine = resolve_engine(engine)
        if mesh is None:
            mesh, axis = engine.collective_mesh() or (None, axis)
    if mesh is not None:
        return _profile_sharded(getattr(sched, "host", sched), c, mesh, axis,
                                reps=reps, warmup=warmup, clock=clock)
    if isinstance(sched, DeviceSchedule):
        ds = sched
    else:
        ds = to_device(sched, resolve_device(device))
    eng = resolve_engine(engine, device=ds.device)
    eng._require_dtype(ds)
    ct = torch.as_tensor(np.asarray(c) if not isinstance(c, torch.Tensor)
                         else c, device=ds.device).to(torch_dtype(ds.dtype))
    if eng.name == "cuda":
        return _profile_stamped(ds, ct, reps=reps, warmup=warmup,
                                engine=eng, clock=clock)
    if eng.name == "torch":
        return _profile_stepwise(ds, ct, reps=reps, warmup=warmup,
                                 clock=clock)
    raise ValueError(f"no per-step profile for engine {eng.name!r}; "
                     "profiled engines: 'torch', 'cuda'")


def profile_operator(op, b=None, *, reps: int = 2, warmup: int = 1,
                     clock=time.perf_counter) -> ScheduleProfile:
    """Profile a built TriangularOperator's main schedule on its device
    with its engine, the operator's own orientation + preamble applied to
    `b` (default: ones), so the profiled c is exactly what a served solve
    would feed the schedule.  A sharded engine routes its mesh and axis
    through (and stages nothing unpadded)."""
    v = np.ones(op.n, dtype=np.float64) if b is None else np.asarray(b)
    if op._reversed:
        v = v[::-1]
    c = op._ts.preamble(v)
    return profile_schedule(op._engine.operator_form(op), c, reps=reps,
                            warmup=warmup,
                            clock=clock, engine=op._engine)


from ..solver.engines import Engine as _EngineBase  # noqa: E402  (the
# engines module imports nothing of obs, so this cannot re-enter it)


class ProfilingEngine(_EngineBase):
    """Engine-protocol wrapper running the per-step profiling loop.

    Opt-in measurement tool: do not register it as a serving default.
    `compile(dsched)` returns a solve fn whose results are exact (the
    profiled execution IS the solve); after each call `last_profile` holds
    the fresh ScheduleProfile.  `base=None` profiles step by step through
    the plain torch loop; `base` the "cuda" engine runs every solve it
    serves as K1's stamped form (`sptrsv_groups_stamped`), which takes one
    right-hand side: a batched one (n, R) is solved column by column and
    `last_profile` is the last column's; `base` a ShardedEngine profiles
    the sharded path over its mesh and axis (the collective split).
    Availability, cache identity, the tuner's sweep shape, the devices it
    runs on and where it stages are the base's.
    """

    def __init__(self, base=None, *, reps: int = 1, warmup: int = 1,
                 clock=time.perf_counter, name: str | None = None):
        self.base = base
        self.reps = int(reps)
        self.warmup = int(warmup)
        self.clock = clock
        self.name = name or f"profiled[{base.name if base else 'stepwise'}]"
        self.last_profile = None
        if base is not None:
            self.supports_batched_rhs = base.supports_batched_rhs
            self.dtypes = base.dtypes
            self.device_types = base.device_types

    # where it stages, what it compiles and over which mesh: the base's
    def placement(self, device=None):
        return (self.base or super()).placement(device)

    def operator_form(self, op, which: str = "main"):
        return (self.base or super()).operator_form(op, which)

    def pack_device(self, device):
        return (self.base or super()).pack_device(device)

    def collective_mesh(self):
        return (self.base or super()).collective_mesh()

    def _require_dtype(self, dsched) -> None:
        (self.base or super())._require_dtype(dsched)

    def available(self) -> bool:
        return self.base.available() if self.base is not None else True

    def cache_token(self) -> str:
        if self.base is not None:
            return f"{self.name}:{self.base.cache_token()}"
        return self.name

    def sweep_shape(self, ts, sched) -> dict:
        if self.base is not None:
            return self.base.sweep_shape(ts, sched)
        return super().sweep_shape(ts, sched)

    def compile(self, dsched):
        self._require_dtype(dsched)
        engine = self.base if self.base is not None else "torch"

        def fn(cv):
            # K1's stamped form takes one column; the sharded path all
            if self.base is not None and cv.ndim == 2 and \
                    self.base.collective_mesh() is None:
                return torch.stack([fn(cv[:, r]) for r in
                                    range(cv.shape[1])], 1)
            prof, x = _profile_and_solve(
                dsched, cv, reps=self.reps, warmup=self.warmup,
                clock=self.clock, device=None, engine=engine)
            self.last_profile = prof
            return x

        return fn
