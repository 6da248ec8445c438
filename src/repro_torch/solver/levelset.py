"""Level-scheduled SpTRSV on torch tensors: device staging + the plain body.

Port of `repro.solver.levelset`.  A compiled `LevelSchedule` (numpy, host)
is staged once per device as a `DeviceSchedule`: its `groups` are a tuple
of per-group leaf tuples of tensors (4 leaves for carry-free groups, 6 with the carry slot
maps).  Indices stay int32 as in the schedule; `dep_coef`/`dinv` keep the
schedule dtype.

`solve_levels` is the plain PyTorch body: a Python loop over steps, each
step applying its width groups in order (gather `x[dep_idx]`, dot over D,
add the carry, scatter into `x[row_ids]` and `carry[carry_out]`).  Running
a step's groups back to back is safe because the schedule compiler
guarantees no lane reads a row (or carry) finalized in the same step.  It
serves the "torch" engine and is the plain version the CUDA kernels are
held against (`kernels/ref.py`).

`schedule_from_numpy` carries any LevelSchedule-shaped object across (for
example one compiled by the JAX package) by duck typing and array copies.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .schedule import LevelSchedule, SchedValuePlan, WidthGroup

__all__ = ["DeviceSchedule", "to_device", "solve_levels", "pad_rhs",
           "resolve_device", "torch_dtype", "schedule_from_numpy"]

# leaf order within a group (row_ids doubles as the c gather index —
# padding lanes hit the zero slot).  Carry leaves are present only for
# groups holding partial-row lanes.
GROUP_LEAVES = ("row_ids", "dep_idx", "dep_coef", "dinv")
CARRY_LEAVES = ("carry_in", "carry_out")


def resolve_device(device=None) -> torch.device:
    """The port's device rule: `None` means the CUDA card, and without one
    that is an error — the port never carries on on the CPU unless the
    caller asked for it (`device="cpu"`)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the host")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev


def torch_dtype(dtype) -> torch.dtype:
    """numpy dtype -> torch dtype (float32/float64 schedules)."""
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


class DeviceSchedule:
    """LevelSchedule staged as torch tensors on one device.

    Each format is staged at first use, so a device holds only what its
    engine reads: `groups` (the padded width groups, for the plain engine
    and the plain versions) or `packed()` (the CUDA kernel's lane list).
    `packed` hands in the schedule's packed form already made (kept on the
    operator's payload, loaded from the disk cache, or refreshed with new
    values), so that `packed()` does not pack it again.
    """

    def __init__(self, sched: LevelSchedule, device, packed=None):
        self.host = sched
        self.device = torch.device(device)
        self.n = sched.n
        self.n_carry = sched.n_carry
        self.dtype = sched.dtype
        self._packed = None if packed is None else packed.to(self.device)

    @functools.cached_property
    def groups(self) -> tuple:
        return tuple(
            tuple(torch.as_tensor(getattr(g, name), device=self.device)
                  for name in GROUP_LEAVES) +
            (tuple(torch.as_tensor(getattr(g, name), device=self.device)
                   for name in CARRY_LEAVES)
             if g.carry_in is not None else ())
            for g in self.host.groups)

    def packed(self):
        """The CUDA kernel's step-major lane list: the one handed in, else
        packed on the host from the host schedule and staged on this device
        once."""
        if self._packed is None:
            from ..kernels.sptrsv_level import pack_schedule
            self._packed = pack_schedule(self.host).to(self.device)
        return self._packed


def to_device(sched: LevelSchedule, device, packed=None) -> DeviceSchedule:
    return DeviceSchedule(sched, device, packed)


def _group_body(x, carry, c_pad, leaves_g):
    """Apply one width-group tile of one step, updating x/carry in place."""
    row_ids, dep_idx, dep_coef, dinv = leaves_g[:4]
    has_carry = len(leaves_g) == 6
    gathered = x[dep_idx]                      # (C, D) or (C, D, R)
    if gathered.ndim == 3:
        partial = torch.einsum("cd,cdr->cr", dep_coef, gathered)
        tot = partial + carry[leaves_g[4]] if has_carry else partial
        xi = (c_pad[row_ids] - tot) * dinv[:, None]
    else:
        partial = (dep_coef * gathered).sum(-1)           # (C,)
        tot = partial + carry[leaves_g[4]] if has_carry else partial
        xi = (c_pad[row_ids] - tot) * dinv
    # padding lanes all write the garbage slot (index n / n_carry+1):
    # in-bounds, and which duplicate wins does not matter
    x[row_ids] = xi
    if has_carry:
        carry[leaves_g[5]] = tot


def _step_body(x, carry, c_pad, step_groups):
    for leaves_g in step_groups:
        _group_body(x, carry, c_pad, leaves_g)


def solve_levels(groups, c_pad: torch.Tensor, n: int,
                 n_carry: int) -> torch.Tensor:
    """Plain body over all steps: c_pad (n+1,) or (n+1, R), last row 0.
    Returns x (n,) or (n, R) in c_pad's dtype, on c_pad's device.  x and
    carry are updated in place (one buffer each, not one per step)."""
    tail = tuple(c_pad.shape[1:])
    x = torch.zeros((n + 1,) + tail, dtype=c_pad.dtype, device=c_pad.device)
    carry = torch.zeros((n_carry + 2,) + tail, dtype=c_pad.dtype,
                        device=c_pad.device)
    num_steps = int(groups[0][0].shape[0]) if groups else 0
    for s in range(num_steps):
        _step_body(x, carry, c_pad, tuple(tuple(l[s] for l in g)
                                          for g in groups))
    return x[:n]


def pad_rhs(c: torch.Tensor) -> torch.Tensor:
    """c (n,) or (n, R) -> c_pad with a zero row n appended."""
    return torch.cat([c, c.new_zeros((1,) + tuple(c.shape[1:]))], dim=0)


def schedule_from_numpy(obj) -> LevelSchedule:
    """Copy any LevelSchedule-shaped object into the port's LevelSchedule.

    `obj` needs `.groups` (each with `width`, `n`, `row_ids`, `dep_idx`,
    `dep_coef`, `dinv`, `carry_in`, `carry_out`) and the scalar fields `n`,
    `n_carry`, `num_levels`, `chunk`, `max_deps`, `compacted`, `build_ms`;
    an optional `value_plan` is copied field by field.  Arrays are copied,
    so the result shares no memory with `obj`.
    """
    def arr(a):
        return None if a is None else np.array(a, copy=True)

    groups = tuple(
        WidthGroup(width=int(g.width), n=int(g.n), row_ids=arr(g.row_ids),
                   dep_idx=arr(g.dep_idx), dep_coef=arr(g.dep_coef),
                   dinv=arr(g.dinv), carry_in=arr(g.carry_in),
                   carry_out=arr(g.carry_out))
        for g in obj.groups)
    plan = getattr(obj, "value_plan", None)
    if plan is not None:
        plan = SchedValuePlan(
            nnz=int(plan.nnz), ent_src=arr(plan.ent_src),
            coef_dst=arr(plan.coef_dst), lane_slot=arr(plan.lane_slot),
            lane_row=arr(plan.lane_row), lane_final=arr(plan.lane_final))
    return LevelSchedule(groups=groups, n=int(obj.n),
                         n_carry=int(obj.n_carry),
                         num_levels=int(obj.num_levels),
                         chunk=int(obj.chunk), max_deps=int(obj.max_deps),
                         compacted=bool(obj.compacted),
                         build_ms=float(obj.build_ms), value_plan=plan)
