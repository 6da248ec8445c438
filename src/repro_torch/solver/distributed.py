"""Distributed SpTRSV over torch.distributed: the lanes of each schedule
step sharded over the ranks of one mesh axis, x replicated and
re-synchronized with one all_gather family per step.

Port of `repro.solver.distributed`.  The collective count is therefore
the schedule's step count — the count the schedule compiler's compaction
minimizes on top of the level count the paper's transformation
minimizes, so the transformation's "fewer synchronization barriers" is
literally fewer all_gathers here.  `count_all_gathers` audits the
invariant by running the step body over the padded host schedule's
shapes on the meta device with a counting collective: exactly one
all_gather family (synchronization point) per step, the carry gathers
riding in the same family.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` with a named axis
(`default_mesh` builds one over the whole world, `mesh_dim_names=
(axis,)`); its device type says where the ranks stage: `cuda:{current
device}` for a CUDA mesh, the CPU for a CPU mesh.  Nothing moves to the
host for a collective (gloo may carry CUDA tensors through host memory
inside the backend; the caller chose that backend).

Where JAX's `shard_map` is one controller that returns the replicated x,
this port is SPMD: every rank builds the same operator and calls the
solve with the same right-hand side, and every rank gets the same x.
Rank r stages only its block of every width group's padded lane
dimension, lanes `[r*C/k, (r+1)*C/k)` (the reference's `P(None, axis)`
block sharding); x and the carry slots are replicated.  Each step
publishes its lanes' values and row ids (and, where a group carries, the
partial sums and their carry slots) through one all_gather family: 2
calls per step, or 4 on a schedule with any carry group, as the
reference issues.  Every rank applies the same gathered updates in the
same order, so x is bitwise the same on every rank.  Host decisions
taken from replicated tensors (refinement rounds, health guards, the
Krylov convergence test) agree across ranks by construction; those taken
from timings do not, so they are taken on the axis' first rank and
broadcast (`agree`).

Width groups are sharded independently over their lane dimension and
their per-step updates are concatenated before the gather, so the number
of collectives per step stays constant however many width classes the
schedule uses.  Every group's lane capacity is padded to a multiple of
the axis size on the host before sharding.  Right-hand sides may be
single `(n,)` or batched `(n, k)`: lanes sharded, columns replicated.

This module is the lowering behind the registered `ShardedEngine`
(`repro_torch.solver.engines`), which memoizes a lowering per (schedule
identity, mesh, axis), so a serving path never pads or stages a schedule
twice.  The plain step body runs on each rank (gather, dot, scale, then
the collective and a scatter): the reference's sharded lowering is plain
jnp outside any Pallas kernel too.
"""
from __future__ import annotations

import threading

import numpy as np
import torch
import torch.distributed as dist

from .schedule import LevelSchedule, WidthGroup

__all__ = ["solve_sharded", "lower_sharded", "count_all_gathers",
           "default_mesh", "require_axis", "mesh_device", "axis_group",
           "agree", "all_ranks", "is_default_mesh"]

# (axis, device type) -> (the default process group it was built on, mesh):
# a process group destroyed and made anew gets a mesh of its own
_DEFAULT_MESHES: dict = {}
_DEFAULT_MESHES_LOCK = threading.RLock()


def default_mesh(axis: str = "model", device_type: str | None = None):
    """One-axis DeviceMesh over every rank of the initialized default
    process group, named `axis`.  `device_type` None means "cuda" when
    this process sees a card, whatever the backend (gloo carries CUDA
    tensors too), and "cpu" only without one.  Built once per (axis, device
    type) and process group, so repeat calls return the identical mesh and
    the lowerings memoized on it hit.  Without an initialized process
    group it raises RuntimeError: the port never makes a world on its own.
    """
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed process group is initialized: call "
            "torch.distributed.init_process_group(...) on every rank "
            "first, or pass mesh= a DeviceMesh")
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.group.WORLD
    key = (axis, device_type or _default_device_type())
    with _DEFAULT_MESHES_LOCK:
        hit = _DEFAULT_MESHES.get(key)
        if hit is not None and hit[0] is world:
            return hit[1]
        mesh = init_device_mesh(key[1], (dist.get_world_size(),),
                                mesh_dim_names=(axis,))
        _DEFAULT_MESHES[key] = (world, mesh)
        return mesh


def _default_device_type() -> str:
    # the port's rule (`levelset.resolve_device`): the card unless the
    # caller asks for the CPU, here with device_type="cpu" or a CPU mesh
    return "cuda" if torch.cuda.is_available() else "cpu"


def is_default_mesh(mesh, axis: str = "model") -> bool:
    """Whether `mesh` is the mesh `default_mesh(axis)` (its default device
    type) returned for the live process group (never builds one)."""
    if not dist.is_initialized():
        return False
    with _DEFAULT_MESHES_LOCK:
        hit = _DEFAULT_MESHES.get((axis, _default_device_type()))
    return hit is not None and hit[0] is dist.group.WORLD and hit[1] is mesh


def require_axis(mesh, axis: str) -> None:
    """Validate that `mesh` is a DeviceMesh and `axis` names one of its
    axes: a TypeError for anything else, an eager ValueError naming the
    mesh's axes for a wrong name, never a KeyError from inside lowering."""
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed.device_mesh."
                        f"DeviceMesh, got {type(mesh).__name__}")
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(
            f"mesh has no axis {axis!r}; its axes are {names} — pass "
            f"mesh_axis=/axis= naming one of them")


def axis_group(mesh, axis: str = "model") -> tuple:
    """(process group, size, this rank's index) of `mesh`'s `axis`."""
    require_axis(mesh, axis)
    group = mesh.get_group(axis)
    return group, dist.get_world_size(group), dist.get_rank(group)


def mesh_device(mesh) -> torch.device:
    """Where a rank of `mesh` stages: its current CUDA device for a CUDA
    mesh, else the mesh's device type."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def agree(value, mesh, axis: str = "model"):
    """The axis' first rank's `value` on every rank of `axis` (a host
    decision taken from timings, which differ between ranks: the ranks
    must take the same one, or their collectives no longer match).  A
    single rank returns `value` itself."""
    group, size, _ = axis_group(mesh, axis)
    if size == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0),
                               group=group)
    return box[0]


def all_ranks(value, mesh, axis: str = "model") -> list:
    """Every rank's `value` of `axis`, in rank order, on every rank: what
    a decision all ranks must take alike is made from (a cache hit, a
    lowering that failed on one rank).  A single rank gets `[value]`."""
    group, size, _ = axis_group(mesh, axis)
    if size == 1:
        return [value]
    out = [None] * size
    dist.all_gather_object(out, value, group=group)
    return out


def _pad_group(g: WidthGroup, mult: int, n: int, n_carry: int) -> WidthGroup:
    """Pad the lane dimension to a multiple of `mult` with inert lanes."""
    S, C = g.row_ids.shape
    C_new = -(-C // mult) * mult
    if C_new == C:
        return g

    def pad2(a, fill):
        out = np.full((S, C_new), fill, dtype=a.dtype)
        out[:, :C] = a
        return out

    dep_idx = np.zeros((S, C_new, g.dep_idx.shape[2]), dtype=g.dep_idx.dtype)
    dep_idx[:, :C] = g.dep_idx
    dep_coef = np.zeros((S, C_new, g.dep_coef.shape[2]),
                        dtype=g.dep_coef.dtype)
    dep_coef[:, :C] = g.dep_coef
    return WidthGroup(
        width=g.width, n=n,
        row_ids=pad2(g.row_ids, n),
        dep_idx=dep_idx,
        dep_coef=dep_coef,
        dinv=pad2(g.dinv, 0),
        carry_in=None if g.carry_in is None else pad2(g.carry_in, n_carry),
        carry_out=None if g.carry_out is None else
        pad2(g.carry_out, n_carry + 1))


def _padded_schedule(sched: LevelSchedule, nshards: int) -> LevelSchedule:
    """The schedule with every group's lane capacity padded to a multiple
    of `nshards` (host-side numpy, no staging)."""
    return LevelSchedule(
        groups=tuple(_pad_group(g, nshards, sched.n, sched.n_carry)
                     for g in sched.groups),
        n=sched.n, n_carry=sched.n_carry, num_levels=sched.num_levels,
        chunk=sched.chunk, max_deps=sched.max_deps,
        compacted=sched.compacted, build_ms=sched.build_ms)


def _group_leaves(g: WidthGroup) -> tuple:
    """A group's leaves in the engines' order (`levelset.GROUP_LEAVES`,
    then `CARRY_LEAVES` where the group carries)."""
    from .levelset import CARRY_LEAVES, GROUP_LEAVES
    names = GROUP_LEAVES + (CARRY_LEAVES if g.carry_in is not None else ())
    return tuple(getattr(g, name) for name in names)


def _stage_block(padded: LevelSchedule, rank: int, nshards: int,
                 device) -> tuple:
    """This rank's block of every group's padded lanes, staged on
    `device`: per group (row_ids, dep_idx, dep_coef, dinv[, carry_in,
    carry_out]), each (S, C/k[, D])."""
    out = []
    for g in padded.groups:
        block = g.row_ids.shape[1] // nshards
        lanes = slice(rank * block, (rank + 1) * block)
        out.append(tuple(torch.as_tensor(np.ascontiguousarray(a[:, lanes]),
                                         device=device)
                         for a in _group_leaves(g)))
    return tuple(out)


def _gather(v: torch.Tensor, group) -> torch.Tensor:
    """Every rank's `v`, concatenated along dim 0 in rank order."""
    k = dist.get_world_size(group)
    out = v.new_empty((k * v.shape[0],) + tuple(v.shape[1:]))
    dist.all_gather_into_tensor(out, v.contiguous(), group=group)
    return out


def _step_update(x, carry, c_pad, step_groups, *, n_carry, group,
                 gather=_gather):
    """One schedule step on this rank's lane block, published to every rank
    by one all_gather family (the per-step synchronization point).
    `gather(v, group)` is injectable so `count_all_gathers` can audit the
    family and the profiler can time the step without its collective; the
    carry machinery leaves the collective entirely when no group of the
    schedule ships carry maps (the common, no-split-row case).  x and
    carry are updated in place and returned."""
    any_carries = any(len(g) == 6 for g in step_groups)
    xis, tots, rids_l, couts_l = [], [], [], []
    for g in step_groups:
        rids, didx, dcoef, dnv = g[:4]
        gathered = x[didx]                     # (C, D) or (C, D, R)
        if gathered.ndim == 3:
            partial = torch.einsum("cd,cdr->cr", dcoef, gathered)
        else:
            partial = (dcoef * gathered).sum(-1)           # (C,)
        tot = partial + carry[g[4]] if len(g) == 6 else partial
        xi = (c_pad[rids] - tot) * (dnv if tot.ndim == 1 else dnv[:, None])
        xis.append(xi)
        rids_l.append(rids)
        if any_carries:
            tots.append(tot)
            couts_l.append(g[5] if len(g) == 6 else torch.full(
                rids.shape, n_carry + 1, dtype=rids.dtype,
                device=rids.device))
    # publish this step's results to every rank: one concatenated
    # all_gather family per step — the quantity compaction minimizes.
    # Padding lanes all write the garbage slots (x[n], carry[n_carry+1])
    xi_all = gather(torch.cat(xis), group)
    rid_all = gather(torch.cat(rids_l), group)
    x[rid_all] = xi_all
    if any_carries:
        tot_all = gather(torch.cat(tots), group)
        cout_all = gather(torch.cat(couts_l), group)
        carry[cout_all] = tot_all
    return x, carry


def _init_state(n: int, n_carry: int, c_pad: torch.Tensor) -> tuple:
    tail = tuple(c_pad.shape[1:])               # () single RHS, (R,) batched
    return (c_pad.new_zeros((n + 1,) + tail),
            c_pad.new_zeros((n_carry + 2,) + tail))


def _sweep(c_pad, per_step, *, n, n_carry, group, gather=_gather):
    """The sharded body over every step: x (n,) or (n, R)."""
    x, carry = _init_state(n, n_carry, c_pad)
    for step_groups in per_step:
        x, carry = _step_update(x, carry, c_pad, step_groups,
                                n_carry=n_carry, group=group, gather=gather)
    return x[:n]


def _per_step(groups: tuple, num_steps: int) -> list:
    """Each step's views of the staged leaves, sliced once."""
    return [tuple(tuple(l[s] for l in g) for g in groups)
            for s in range(num_steps)]


def lower_sharded(sched: LevelSchedule, mesh, axis: str = "model"):
    """Build the sharded solver fn(c) -> x for a fixed schedule.

    Pads the schedule's lanes to a multiple of the axis size and stages
    this rank's block on the mesh's device.  The returned fn takes `(n,)`
    or batched `(n, k)` right-hand sides (a tensor on the mesh's device,
    or numpy, which is staged there; cast to the schedule dtype) and
    validates the leading dimension eagerly; every rank of the axis must
    call it with the same c.  Prefer `ShardedEngine.compile` (or
    `solve_sharded`), which memoizes this lowering per schedule identity.
    """
    from .levelset import pad_rhs, torch_dtype
    group, nshards, rank = axis_group(mesh, axis)
    device = mesh_device(mesh)
    padded = _padded_schedule(sched, nshards)
    per_step = _per_step(_stage_block(padded, rank, nshards, device),
                         padded.num_steps)
    n, n_carry = padded.n, padded.n_carry
    dtype = torch_dtype(padded.dtype) if padded.groups else torch.float32

    def run(c):
        if not isinstance(c, torch.Tensor):
            c = torch.as_tensor(np.asarray(c), device=device)
        if c.ndim not in (1, 2) or c.shape[0] != n:
            raise ValueError(
                f"right-hand side must be ({n},) or ({n}, k) to match the "
                f"schedule, got shape {tuple(c.shape)}")
        if c.device.type != device.type:
            raise ValueError(f"the sharded schedule lies on {device}, the "
                             f"right-hand side on {c.device}")
        return _sweep(pad_rhs(c.to(dtype)), per_step, n=n, n_carry=n_carry,
                      group=group)

    return run


def solve_sharded(sched: LevelSchedule, c, mesh,
                  axis: str = "model") -> np.ndarray:
    """Solve with step lanes sharded over `axis` of `mesh`; every rank
    calls it with the same c and gets the same x (numpy, the schedule
    dtype).

    Routed through the `ShardedEngine` machinery, so repeat calls on the
    same schedule object reuse the memoized lowering instead of re-padding
    and re-staging the groups.  `c` may be `(n,)` or batched `(n, k)`; a
    leading dimension that does not match the schedule raises ValueError.
    """
    from .engines import sharded_engine
    fn = sharded_engine(mesh, axis).compile(sched)
    return fn(np.asarray(c)).cpu().numpy()


def count_all_gathers(sched, mesh=None, axis: str = "model") -> dict:
    """Audit the collective count of one sharded solve without running one
    (no collective, no device staging, any mesh size; default a mesh of
    one rank, which needs no process group).

    Runs the sharded step body over the padded HOST schedule's shapes on
    the meta device with a counting collective and returns ``{"steps",
    "families", "calls"}``: `families` is the number of steps that issued
    at least one all_gather — the per-step synchronization barriers — and
    `calls` the raw all_gather calls: 2 per step (values + row ids), 4
    per step on a schedule with any split-row group (the carry machinery
    keys off the leaf structure, which every step shares).  The module's
    invariant, which the tests and `chip_smoke.py` assert, is
    ``families == steps``.
    """
    from .levelset import torch_dtype
    nshards = 1 if mesh is None else axis_group(mesh, axis)[1]
    padded = _padded_schedule(getattr(sched, "host", sched), nshards)
    # every group's full padded lanes, as the reference traces them: only
    # the collective structure matters here, and the lane sharding does
    # not change it
    groups = tuple(tuple(torch.empty(a.shape, dtype=torch_dtype(a.dtype),
                                     device="meta")
                         for a in _group_leaves(g))
                   for g in padded.groups)
    per_step: list[int] = []

    def gather(v, group):
        per_step[-1] += 1
        return v.new_empty((nshards * v.shape[0],) + tuple(v.shape[1:]))

    dtype = torch_dtype(padded.dtype) if padded.groups else torch.float32
    c_pad = torch.empty((padded.n + 1,), dtype=dtype, device="meta")
    x, carry = _init_state(padded.n, padded.n_carry, c_pad)
    for step_groups in _per_step(groups, padded.num_steps):
        per_step.append(0)
        x, carry = _step_update(x, carry, c_pad, step_groups,
                                n_carry=padded.n_carry, group=None,
                                gather=gather)
    return {"steps": padded.num_steps,
            "families": sum(1 for k in per_step if k > 0),
            "calls": sum(per_step)}
