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

Unknown names raise `ValueError` listing the registered engines.  There
are no fallback chains in the port yet: an engine that cannot serve a
schedule (wrong dtype, wrong device, failed build) raises, and nothing
substitutes another engine for it.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

__all__ = ["Engine", "TorchEngine", "CudaEngine", "register_engine",
           "resolve_engine", "get_engine", "registered_engines",
           "default_engine_for"]


class Engine:
    """Base class / protocol for SpTRSV execution engines (module doc)."""

    name: str = "abstract"
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
