"""Production mesh construction.

Port of `repro.launch.mesh`.  `make_production_mesh` and
`make_local_mesh` return a `train.resilience.MeshPlan` whose `.shape` is
the reference's mesh shape, {"data": 16, "model": 16} or {"pod": 2,
"data": 16, "model": 16} for the production mesh, and whose `.mesh` is
the `DeviceMesh` over the live world with the reference's axis names
when a process group of the plan's size is up (else None: the plan
alone, as the dry run and the sharding tests read it).  Functions, never
module constants: importing this module touches no device or process
group.
"""
from __future__ import annotations

import torch.distributed as dist

from ..train.resilience import MeshPlan, plan_mesh

__all__ = ["make_production_mesh", "make_local_mesh"]


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None) -> MeshPlan:
    """The (16, 16) ("data", "model") plan, or (2, 16, 16) with "pod"."""
    return plan_mesh(16, 16, pod=2 if multi_pod else None,
                     device_type=device_type)


def make_local_mesh(model: int = 1, device_type: str | None = None
                    ) -> MeshPlan:
    """The (world / model, model) ("data", "model") plan over the live
    world (one rank without a process group)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % model:
        raise ValueError(f"a model axis of {model} does not divide a "
                         f"world of {n}")
    return plan_mesh(n // model, model, device_type=device_type)
