"""Execution-engine protocol + registry: the single seam for solve dispatch.

Port of `repro.solver.engines`.  Every engine is a registered object with
capability metadata, resolved through one entry point:

    eng = resolve_engine("cuda")          # name, Engine instance, or None
    fn  = eng.compile(dsched)             # DeviceSchedule -> torch callable
    x   = fn(c)                           # c: (n,) or batched (n, R)

Three engines are registered:
  * "torch" — the plain PyTorch body (`levelset.solve_levels`) on the
    schedule's device, any schedule dtype.
  * "cuda"  — the hand-written Hopper kernels K1/K2
    (`kernels/sptrsv_level.py`), float32 only like the reference's Pallas
    engine; `available()` is False without CUDA.
  * "sharded" — `ShardedEngine`: the lanes of each step sharded over one
    axis of a `torch.distributed` DeviceMesh, one all_gather family per
    step (`solver/distributed.py`), on the mesh's device.  It is reached
    only through an explicit `mesh=` or `engine="sharded"`; the
    registered instance meshes the whole initialized world lazily, and
    `sharded_engine(mesh, axis)` keeps one instance per mesh, so the
    lowering memo is never split.  `resolve_placement` is where the
    facades turn (engine, device, mesh) into an engine and the device it
    stages on: a mesh's device, and a `device=` that disagrees raises.

The facades ask the engine what it reads and how its ranks decide alike
(`placement`, `operator_form`, `pack_device`, `collective_mesh`, `agree`,
`all_ranks`, `writes_disk`); only the sharded engine departs from the
single-device defaults.

Each engine also says what one sweep costs it, for the tuner
(`sweep_shape`): the plain engine runs the schedule's steps over its
padded width groups, the CUDA kernel the DAG's levels over the packed rows.

Unknown names raise `ValueError` listing the registered engines.

Fallback chains (`fallback_chains`, `set_fallback_chain`,
`engine_fallbacks`) name the engines `TriangularOperator.solve` tries,
in order, when the requested one is unavailable or its compile or call
raises; each downgrade is warned (`EngineFallbackWarning`) and counted,
and an exhausted chain raises `EngineFallbackError`.  The port's table is
`{"cuda": (), "torch": (), "sharded": ("cuda", "torch")}`: the
reference's terminal engine is a compiled path on the same device, and
the port's only counterpart to it is the plain body, which never serves
the card.  The resolution enforces that whatever the table says: for a
schedule staged on a CUDA device `engine_fallbacks` never returns an
engine marked `plain`, and it never returns an engine that does not run
on the schedule's device.  So the sharded chain resolves by the staged
device: K1 ("cuda") on a card, the plain body on the CPU.  A caller who
asks for `engine="torch"` explicitly gets it; that is a choice, not a
fallback.  The single-device engines' chains are empty, so a solve makes
one attempt; a downgrade happens for a sharded operator whose mesh is
lost, and for an engine a user registers with a chain of its own, as the
CPU parity tests do.
"""
from __future__ import annotations

import collections
import threading

import numpy as np
import torch

__all__ = ["Engine", "TorchEngine", "CudaEngine", "ShardedEngine",
           "sharded_engine", "register_engine", "resolve_engine",
           "resolve_placement", "get_engine", "registered_engines",
           "default_engine_for", "fallback_chains", "set_fallback_chain",
           "engine_fallbacks"]


class Engine:
    """Base class / protocol for SpTRSV execution engines (module doc)."""

    name: str = "abstract"
    # the plain PyTorch body: never a fallback for a schedule on a card
    plain: bool = False
    supports_batched_rhs: bool = True
    dtypes: tuple = ("float32", "float64")
    device_types: tuple = ("cpu", "cuda")

    def available(self) -> bool:
        return True

    def compile(self, dsched):
        """DeviceSchedule -> callable fn(c) -> x over tensors on the
        schedule's device, in the schedule dtype."""
        raise NotImplementedError

    def _require_dtype(self, dsched) -> None:
        """Enforce the declared capabilities — never a silent cast, never a
        silent move to another device.  Every concrete compile() calls this
        first."""
        got = np.dtype(dsched.dtype).name
        if got not in self.dtypes:
            raise ValueError(
                f"engine {self.name!r} supports dtypes "
                f"{tuple(self.dtypes)} but the schedule dtype is {got!r}; "
                f"recompile the schedule with a supported dtype or "
                f"resolve an engine that declares {got!r}")
        if dsched.device.type not in self.device_types:
            raise ValueError(
                f"engine {self.name!r} runs on {tuple(self.device_types)} "
                f"but the schedule is staged on {dsched.device}")
        if not self.available():
            raise RuntimeError(f"engine {self.name!r} is not available in "
                               "this process")

    def cache_token(self) -> str:
        """Identity recorded in cache keys ("which engine was timed")."""
        return self.name

    # -- what the operator hands this engine, and how its ranks agree ------
    # (the facades ask these instead of knowing any engine's policy)

    def placement(self, device=None) -> torch.device:
        """The device a schedule this engine serves is staged on:
        `levelset.resolve_device(device)`, the card unless the caller asks
        for the CPU."""
        from .levelset import resolve_device
        return resolve_device(device)

    def operator_form(self, op, which: str = "main"):
        """The form of operator `op`'s main schedule ("main") or T-factor
        preamble schedule ("preamble"; None for an identity preamble) that
        `compile` takes: staged on op's device, on a card with the SpTRSV
        kernel's packed tiles."""
        return op._staged() if which == "main" else op._preamble_staged()

    def pack_device(self, device):
        """Where an operator on `device` packs and certifies the SpTRSV
        kernel's tiles for this engine: `device` (only a card packs), or
        None for an engine that reads no packed form."""
        return device

    def collective_mesh(self):
        """(mesh, axis) whose ranks run this engine's compiled fns as one
        SPMD program, or None: a single-device engine."""
        return None

    def agree(self, value):
        """The first rank's `value` on every rank of `collective_mesh()`
        (a decision taken from timings, which differ between ranks); the
        value itself on a single-device engine."""
        mesh = self.collective_mesh()
        if mesh is None:
            return value
        from .distributed import agree
        return agree(value, *mesh)

    def all_ranks(self, value) -> list:
        """Every rank's `value` of `collective_mesh()`, in rank order
        (`[value]` on a single-device engine)."""
        mesh = self.collective_mesh()
        if mesh is None:
            return [value]
        from .distributed import all_ranks
        return all_ranks(value, *mesh)

    def writes_disk(self) -> bool:
        """Whether this process writes the disk tier for what this engine
        serves: always, except on the ranks after the first of a mesh."""
        mesh = self.collective_mesh()
        if mesh is None:
            return True
        from .distributed import axis_group
        return axis_group(*mesh)[2] == 0

    def sweep_shape(self, ts, sched) -> dict:
        """What one sweep of the transformed system `ts`, compiled into
        `sched`, runs on this engine, for the tuner's cost model
        (`repro_torch.core.portfolio.CostModel.predict`): its steps,
        padded flops and bytes, the T-factor preamble's steps and the
        launches.  This engine steps through the schedule and the preamble
        schedule (`schedule_for_preamble`), one launch each."""
        pre_steps = 0
        if ts.T.nnz:
            from .schedule import schedule_for_preamble
            psched, _, _ = schedule_for_preamble(
                ts, chunk=sched.chunk, max_deps=sched.max_deps,
                dtype=sched.dtype)
            pre_steps = psched.num_steps
        return {"steps": sched.num_steps,
                "padded_flops": sched.padded_flops(),
                "memory_bytes": sched.memory_bytes(),
                "preamble_steps": pre_steps,
                "launches": 1 + int(ts.T.nnz > 0)}

    def capabilities(self) -> dict:
        return {
            "name": self.name,
            "supports_batched_rhs": self.supports_batched_rhs,
            "dtypes": list(self.dtypes),
            "device_types": list(self.device_types),
            "available": self.available(),
        }

    def __repr__(self) -> str:  # pragma: no cover
        return f"{type(self).__name__}(name={self.name!r})"


class TorchEngine(Engine):
    """The plain PyTorch body: a loop over steps of gather/dot/scatter."""

    name = "torch"
    plain = True

    def compile(self, dsched):
        from .levelset import pad_rhs, solve_levels
        self._require_dtype(dsched)
        groups, n, n_carry = dsched.groups, dsched.n, dsched.n_carry
        return lambda c: solve_levels(groups, pad_rhs(c), n, n_carry)


class CudaEngine(Engine):
    """Hand-written Hopper kernels: K1 for (n,), K2 for (n, R); one launch
    per solve.  float32 on CUDA tensors only."""

    name = "cuda"
    dtypes = ("float32",)
    device_types = ("cuda",)

    def available(self) -> bool:
        return torch.cuda.is_available()

    def sweep_shape(self, ts, sched) -> dict:
        """The kernel's steps are the DAG's levels as the packing leaves
        them (carry chains fused, no lane cap, coefficients that are 0 in
        the schedule dtype dropped), for the main system and for the
        preamble's; flops and bytes are those of the rows and deps of
        both that the tile kernel solves
        (`kernels.sptrsv_level.step_flops`/`step_bytes`).  The first
        level, the dependency-free rows, goes to a pass on every SM at
        full bandwidth (microseconds for 100,000 rows, where one block
        would take a hundred): it is charged as a step and a launch, not
        by its rows.  Read from the packed schedules themselves
        (`pack_schedule`), as the build packs the winner."""
        from ..kernels.sptrsv_level import pack_schedule, step_bytes, \
            step_flops
        from .schedule import schedule_for_preamble
        packs = [pack_schedule(sched)]
        if ts.T.nnz:
            psched, _, _ = schedule_for_preamble(
                ts, chunk=sched.chunk, max_deps=sched.max_deps,
                dtype=sched.dtype)
            packs.append(pack_schedule(psched))
        rows = np.concatenate([p.step_rows[1:] for p in packs])
        deps = np.concatenate([p.step_deps[1:] for p in packs])
        return {"steps": packs[0].num_steps,
                "preamble_steps": sum(p.num_steps for p in packs[1:]),
                "launches": sum(p.launches for p in packs),
                "padded_flops": int(step_flops(rows, deps).sum()),
                "memory_bytes": int(step_bytes(rows, deps).sum())}

    def compile(self, dsched):
        from ..kernels.sptrsv_level import sptrsv_groups, sptrsv_groups_multi
        from .levelset import pad_rhs
        self._require_dtype(dsched)
        n, n_carry = dsched.n, dsched.n_carry
        # the kernel reads only the packed lane list: the padded width
        # groups are never staged on the card for it
        packed = dsched.packed()

        def fn(c):
            kern = sptrsv_groups_multi if c.ndim == 2 else sptrsv_groups
            return kern(None, pad_rhs(c).contiguous(), n=n,
                        n_carry=n_carry, packed=packed)

        return fn


class ShardedEngine(Engine):
    """torch.distributed engine: the lanes of each step sharded over one
    mesh axis, x replicated, ONE all_gather family per schedule step — the
    transformation's "fewer barriers" is literally fewer collectives
    (`solver/distributed.py`).  Batched (n, k) right-hand sides run with
    the lanes sharded and the columns replicated.  Every rank of the axis
    calls the compiled fn with the same c and gets the same x.

    `mesh=None` (the registered instance) meshes the whole initialized
    world along `axis` at first use (`distributed.default_mesh`).  The
    schedule is staged on the mesh's device.  Lowering is memoized per
    (schedule identity, mesh, axis): repeat compiles of one schedule
    return the identical callable and never pad or stage the groups again.
    The engine runs the plain step body on each rank, but it is no plain
    engine: it is reached only by an explicit `mesh=` or
    `engine="sharded"`, and its chain falls back to K1 on a card.  It
    lowers from the host schedule (`operator_form`): an operator it serves
    stages no unpadded schedule and packs none of K1's tiles.  A lowering
    is built by every rank or by none: a rank whose lowering fails fails
    every rank's compile, so that all of them walk the chain together and
    none is left in an all_gather the others never join.
    """

    def __init__(self, mesh=None, axis: str = "model",
                 name: str = "sharded"):
        if mesh is not None:
            # fail at construction, not with a KeyError deep in lowering
            from .distributed import require_axis
            require_axis(mesh, axis)
        self.name = name
        self.mesh = mesh            # None: the whole world, resolved lazily
        self.axis = axis
        # (id(schedule), id(mesh), axis) -> (weakref(schedule), mesh, fn);
        # the weakref guards against id() reuse after garbage collection.
        # Bounded LRU, each entry pins a staged lane block
        self._lowered: collections.OrderedDict = collections.OrderedDict()
        self._lowered_max: int = 32
        # held across the lowering itself, so that threads missing on one
        # schedule lower it once
        self._lowered_lock = threading.RLock()

    def available(self) -> bool:
        return torch.distributed.is_available()

    def resolve_mesh(self):
        """The engine's mesh: the one it was made with, else the whole
        initialized world's along `axis`."""
        if self.mesh is not None:
            return self.mesh
        from .distributed import default_mesh
        return default_mesh(axis=self.axis)

    def collective_mesh(self):
        return self.resolve_mesh(), self.axis

    def operator_form(self, op, which: str = "main"):
        """The host schedules: the lowering pads and stages its own lane
        block of them."""
        return op.schedule if which == "main" else op._preamble_host()[0]

    def pack_device(self, device):
        return None

    def placement(self, device=None) -> torch.device:
        """The device this engine's schedules are staged on: the mesh's.
        A `device` that disagrees with it raises ValueError."""
        from .distributed import mesh_device
        here = mesh_device(self.resolve_mesh())
        if device is not None:
            want = torch.device(device)
            if want.type != here.type or (want.index is not None
                                          and want.index != here.index):
                raise ValueError(
                    f"device={str(want)!r} disagrees with the mesh, whose "
                    f"ranks stage on {here}; leave device= unset under "
                    f"mesh=")
        return here

    def cache_token(self) -> str:
        """Mesh-qualified identity: two sharded engines over different
        meshes never share a measured-mode cache entry (collective costs
        depend on the backend and the ranks)."""
        import torch.distributed as dist
        mesh = self.resolve_mesh()
        group = mesh.get_group(self.axis)
        ranks = ",".join(str(r) for r in dist.get_process_group_ranks(group))
        return (f"{self.name}[{self.axis}:{dist.get_backend(group)}:"
                f"{mesh.device_type}:{dist.get_world_size(group)}:{ranks}]")

    def _require_dtype(self, dsched) -> None:
        """The dtype gate of every engine; a staged schedule must lie where
        the mesh stages (a host LevelSchedule is padded and staged by the
        lowering itself)."""
        got = np.dtype(dsched.dtype).name
        if got not in self.dtypes:
            raise ValueError(
                f"engine {self.name!r} supports dtypes "
                f"{tuple(self.dtypes)} but the schedule dtype is {got!r}")
        if not self.available():
            raise RuntimeError(f"engine {self.name!r} is not available in "
                               "this process")
        if getattr(dsched, "device", None) is not None:
            self.placement(dsched.device)

    def sweep_shape(self, ts, sched) -> dict:
        """The padded schedule's steps, flops and bytes (every group's
        lanes padded to a multiple of the axis size), the preamble's
        steps, one launch per schedule, and the barriers: the lowering
        runs the preamble's schedule too, one all_gather family a step of
        either."""
        from .distributed import _padded_schedule, axis_group
        nshards = axis_group(self.resolve_mesh(), self.axis)[1]
        shape = super().sweep_shape(ts, _padded_schedule(sched, nshards))
        shape["barriers"] = shape["steps"] + shape["preamble_steps"]
        return shape

    def compile(self, dsched):
        import weakref
        from . import distributed as _dist
        self._require_dtype(dsched)
        # lowering starts from the HOST schedule (padding is a numpy
        # pass); a DeviceSchedule hands it back via .host
        host = getattr(dsched, "host", dsched)
        mesh = self.resolve_mesh()
        key = (id(host), id(mesh), self.axis)
        with self._lowered_lock:
            hit = self._lowered.get(key)
            if hit is not None and hit[0]() is host and hit[1] is mesh:
                self._lowered.move_to_end(key)
                return hit[2]
            # looked up at call time: core.faults.lose_mesh patches it
            fn, err = None, None
            try:
                fn = _dist.lower_sharded(host, mesh, axis=self.axis)
            except Exception as e:  # noqa: BLE001 - agreed, then raised
                err = e
            failed = [(r, why) for r, why in enumerate(_dist.all_ranks(
                None if err is None else f"{type(err).__name__}: {err}",
                mesh, self.axis)) if why is not None]
            if failed:
                if err is not None:
                    raise err
                raise RuntimeError(
                    "the sharded lowering failed on rank(s) " + "; ".join(
                        f"{r}: {why}" for r, why in failed))
            for k in [k for k, v in self._lowered.items()
                      if v[0]() is None]:
                del self._lowered[k]                 # drop collected entries
            self._lowered[key] = (weakref.ref(host), mesh, fn)
            while len(self._lowered) > self._lowered_max:
                self._lowered.popitem(last=False)
            return fn


# -- fallback chains ----------------------------------------------------------

# engine name -> ordered degradation chain tried when the engine is
# unavailable or its compile or call raises (module doc).  Empty for the
# single-device engines: no engine stands in for the CUDA kernel.  The
# sharded engine's resolves by the staged device: K1 on a card, the plain
# body on the CPU
_FALLBACK_CHAINS: dict[str, tuple] = {
    "cuda": (),
    "torch": (),
    "sharded": ("cuda", "torch"),
}


def fallback_chains() -> dict:
    """Copy of the configured name -> chain map."""
    return dict(_FALLBACK_CHAINS)


def set_fallback_chain(name: str, chain) -> None:
    """Configure the degradation chain for an engine name.  `chain` is an
    ordered iterable of registered engine names; an empty chain means
    "fail fast, no downgrade"."""
    _FALLBACK_CHAINS[name] = tuple(chain)


def engine_fallbacks(engine, device="cpu") -> tuple:
    """The resolved degradation chain for an engine serving a schedule
    staged on `device`: registered Engine instances, in order, the engine
    itself excluded.  Names that are not registered are skipped (a chain
    must never raise during resolution — it is consulted on the failure
    path), and so is every engine that does not run on `device`'s type
    and, on a CUDA device, every engine marked `plain`."""
    dev_type = torch.device(device).type
    out = []
    for name in _FALLBACK_CHAINS.get(getattr(engine, "name", None), ()):
        eng = _REGISTRY.get(name)
        if eng is None or eng is engine or eng in out or \
                dev_type not in getattr(eng, "device_types",
                                        (dev_type,)) or \
                (dev_type == "cuda" and getattr(eng, "plain", False)):
            continue
        out.append(eng)
    return tuple(out)


# -- registry -----------------------------------------------------------------

_REGISTRY: dict[str, Engine] = {}
_REGISTRY_LOCK = threading.RLock()
# (id(mesh) or None, axis) -> ShardedEngine: one instance per mesh, so the
# lowering memo is never split.  Bounded LRU: each instance pins its
# lowerings.  Keyed by identity: a DeviceMesh compares equal to one of the
# same shape over a process group since destroyed
_SHARDED_INSTANCES: collections.OrderedDict = collections.OrderedDict()
_SHARDED_INSTANCES_MAX = 8
_SHARDED_INSTANCES_LOCK = threading.RLock()


def sharded_engine(mesh=None, axis: str = "model") -> ShardedEngine:
    """Memoized ShardedEngine per (mesh, axis).  `mesh=None`, or the mesh
    `distributed.default_mesh(axis)` returned, gives the registered
    instance when its axis is `axis`; any other mesh one instance of its
    own.  Every call site (solve_sharded, `from_csr(mesh=...)`,
    `Preconditioner(mesh=...)`, engine="sharded") thus lands on ONE
    instance per mesh."""
    from .distributed import is_default_mesh, require_axis
    if mesh is not None:
        require_axis(mesh, axis)
    reg = _REGISTRY.get("sharded")
    default = reg if isinstance(reg, ShardedEngine) else None
    if default is not None and default.axis == axis and (
            mesh is None or (default.mesh is None
                             and is_default_mesh(mesh, axis))):
        return default
    key = (None if mesh is None else id(mesh), axis)
    with _SHARDED_INSTANCES_LOCK:
        eng = _SHARDED_INSTANCES.get(key)
        if eng is None or eng.mesh is not mesh:
            eng = _SHARDED_INSTANCES[key] = ShardedEngine(mesh, axis=axis)
        _SHARDED_INSTANCES.move_to_end(key)
        while len(_SHARDED_INSTANCES) > _SHARDED_INSTANCES_MAX:
            _SHARDED_INSTANCES.popitem(last=False)
        return eng


def register_engine(engine: Engine, overwrite: bool = False) -> Engine:
    """Register an engine under `engine.name`; returns it for chaining."""
    if not isinstance(engine.name, str) or not engine.name:
        raise TypeError(f"engine must carry a non-empty string name: "
                        f"{engine!r}")
    with _REGISTRY_LOCK:
        if engine.name in _REGISTRY and not overwrite:
            raise ValueError(f"engine {engine.name!r} already registered "
                             f"(pass overwrite=True to replace)")
        _REGISTRY[engine.name] = engine
    return engine


def registered_engines() -> tuple:
    """Sorted names of every registered engine (available or not)."""
    return tuple(sorted(_REGISTRY))


def get_engine(name: str) -> Engine:
    """Look a registered engine up by name; unknown names raise ValueError
    listing the registered options (never a silent fallback)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown engine {name!r}; registered engines: "
            f"{list(registered_engines())}") from None


def default_engine_for(device: torch.device) -> Engine:
    """The kernel engine on a CUDA device, the plain engine on the CPU."""
    return get_engine("cuda" if torch.device(device).type == "cuda"
                      else "torch")


def resolve_engine(spec=None, *, device="cpu", mesh=None,
                   mesh_axis: str = "model") -> Engine:
    """Resolve an engine spec: None -> the default for `device`, a name
    string -> registry lookup, an Engine (or anything with name + compile)
    passes through.

    `mesh=` (with `mesh_axis=`) resolves to the shared ShardedEngine for
    that mesh instead — the ONE place the facades' mesh option maps to an
    engine — and is mutually exclusive with an explicit spec."""
    if mesh is not None:
        if spec is not None:
            raise ValueError("pass either mesh= or engine=, not both "
                             "(mesh= implies the sharded engine)")
        return sharded_engine(mesh, mesh_axis)
    if spec is None:
        return default_engine_for(device)
    if isinstance(spec, str):
        return get_engine(spec)
    if isinstance(spec, Engine) or (hasattr(spec, "compile")
                                    and hasattr(spec, "name")):
        return spec
    raise TypeError(f"engine spec must be None, a registered name, or an "
                    f"Engine instance, got {type(spec).__name__}")


def resolve_placement(engine=None, device=None, *, mesh=None,
                      mesh_axis: str = "model") -> tuple:
    """(engine, device) for the facades: the engine as `resolve_engine`
    resolves it, and the device it stages on (`Engine.placement`: the
    card unless the caller asks for the CPU; the sharded engine's is its
    mesh's, and a `device=` that disagrees raises ValueError).  A missing
    engine is the device's default."""
    from .levelset import resolve_device
    if engine is None and mesh is None:
        dev = resolve_device(device)
        return default_engine_for(dev), dev
    eng = resolve_engine(engine, mesh=mesh, mesh_axis=mesh_axis)
    return eng, eng.placement(device)


register_engine(TorchEngine())
register_engine(CudaEngine())
register_engine(ShardedEngine())
