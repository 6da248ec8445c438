"""Execution-engine protocol + registry: the single seam for solve dispatch.

Port of `repro.solver.engines`.  Every engine is a registered object with
capability metadata, resolved through one entry point:

    eng = resolve_engine("cuda")          # name, Engine instance, or None
    fn  = eng.compile(dsched)             # DeviceSchedule -> torch callable
    x   = fn(c)                           # c: (n,) or batched (n, R)

Two engines are registered:
  * "torch" — the plain PyTorch body (`levelset.solve_levels`) on the
    schedule's device, any schedule dtype.
  * "cuda"  — the hand-written Hopper kernels K1/K2
    (`kernels/sptrsv_level.py`), float32 only like the reference's Pallas
    engine; `available()` is False without CUDA.

Each engine also says what one sweep costs it, for the tuner
(`sweep_shape`): the plain engine runs the schedule's steps over its
padded width groups, the CUDA kernel the DAG's levels over the packed rows.

Unknown names raise `ValueError` listing the registered engines.

Fallback chains (`fallback_chains`, `set_fallback_chain`,
`engine_fallbacks`) name the engines `TriangularOperator.solve` tries,
in order, when the requested one is unavailable or its compile or call
raises; each downgrade is warned (`EngineFallbackWarning`) and counted,
and an exhausted chain raises `EngineFallbackError`.  The port's table is
`{"cuda": (), "torch": ()}`: the reference's terminal engine is a
compiled path on the same device, and the port's only counterpart to it
is the plain body, which never serves the card.  The resolution enforces
that whatever the table says: for a schedule staged on a CUDA device
`engine_fallbacks` never returns an engine marked `plain`.  A caller who
asks for `engine="torch"` explicitly gets it; that is a choice, not a
fallback.  With the port's own engines every chain is empty, so a solve
makes one attempt; a downgrade happens only for an engine a user
registers with a chain of its own, as the CPU parity tests do.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

__all__ = ["Engine", "TorchEngine", "CudaEngine", "register_engine",
           "resolve_engine", "get_engine", "registered_engines",
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


# -- fallback chains ----------------------------------------------------------

# engine name -> ordered degradation chain tried when the engine is
# unavailable or its compile or call raises (module doc).  Empty for both
# of the port's engines: no engine stands in for the CUDA kernel
_FALLBACK_CHAINS: dict[str, tuple] = {
    "cuda": (),
    "torch": (),
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
    path), and so, on a CUDA device, is every engine marked `plain`."""
    on_card = torch.device(device).type == "cuda"
    out = []
    for name in _FALLBACK_CHAINS.get(getattr(engine, "name", None), ()):
        eng = _REGISTRY.get(name)
        if eng is None or eng is engine or eng in out or \
                (on_card and getattr(eng, "plain", False)):
            continue
        out.append(eng)
    return tuple(out)


# -- registry -----------------------------------------------------------------

_REGISTRY: dict[str, Engine] = {}
_REGISTRY_LOCK = threading.RLock()


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


def resolve_engine(spec=None, *, device="cpu") -> Engine:
    """Resolve an engine spec: None -> the default for `device`, a name
    string -> registry lookup, an Engine (or anything with name + compile)
    passes through."""
    if spec is None:
        return default_engine_for(device)
    if isinstance(spec, str):
        return get_engine(spec)
    if isinstance(spec, Engine) or (hasattr(spec, "compile")
                                    and hasattr(spec, "name")):
        return spec
    raise TypeError(f"engine spec must be None, a registered name, or an "
                    f"Engine instance, got {type(spec).__name__}")


register_engine(TorchEngine())
register_engine(CudaEngine())
