"""Level-scheduled SpTRSV on Hopper: the CUDA kernel's wrappers and packing.

Replaces the Pallas TPU kernels of `src/repro/kernels/sptrsv_level.py`:
  * K1 `sptrsv_groups_pallas` (one right-hand side)   -> `sptrsv_groups`
  * K2 `sptrsv_groups_pallas_multi` ((n+1, R) c_pad)  -> `sptrsv_groups_multi`
  * K3 `sptrsv_levels_pallas` (legacy flat signature) -> `sptrsv_levels`,
    a thin wrapper over K1 that adds no kernel.

What bounds it on the H100: the schedule's S dependent steps, not bytes —
a solve moves the schedule, c and x once (a few MB, microseconds at
3.35 TB/s), while each step pays the latency of a dependent gather, an
FMA chain, a store and a block barrier.  The kernel
(`csrc/sptrsv_level.cu`) runs the whole solve in one launch as one thread
block looping over the steps with `__syncthreads()` between them, so no
step pays a launch.  Its design notes are in the source.

The packing and grid math stay here in Python: `pack_groups` turns the
width groups into a step-major lane list (step offsets; per-lane row,
carry slots, dinv and dep offset; a flat dep list), dropping padding lanes
and zero-coefficient padding slots.  `emulate_packed` runs the kernel's
per-step loop in torch on the same packed arrays, so a packing bug fails
the CPU tests.

Dispatch: a wrapper given CPU tensors runs the plain version
(`kernels/ref.py`) and counts it under "plain"; given CUDA tensors it
launches the kernel or raises.  `LAUNCHES` counts launches per entry point.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from . import ref

__all__ = ["PackedSchedule", "pack_groups", "pack_schedule",
           "emulate_packed", "sptrsv_groups", "sptrsv_groups_multi",
           "sptrsv_levels", "LAUNCHES", "reset_launch_counts",
           "MAX_THREADS"]

# launches per entry point: K1, K2, K3 (which launches through K1), and
# the plain version taken for CPU tensors
LAUNCHES = {"sptrsv_groups": 0, "sptrsv_groups_multi": 0,
            "sptrsv_levels": 0, "plain": 0}

MAX_THREADS = 1024          # one block: the kernel's __launch_bounds__


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclasses.dataclass(frozen=True)
class PackedSchedule:
    """Step-major lane list consumed by the CUDA kernel (and its emulator).

    step_ptr (S+1,) int32      lanes of step s are step_ptr[s]:step_ptr[s+1]
    lane_row (L,) int32        row to finalize; n for a partial-row lane
    lane_cin (L,) int32        carry slot to add (n_carry: the zero slot)
    lane_cout (L,) int32       carry slot to write (n_carry+1: none)
    lane_dinv (L,) float32     1/diag (0 for partial-row lanes)
    dep_ptr (L+1,) int32       deps of lane l are dep_ptr[l]:dep_ptr[l+1]
    dep_idx (E,) int32, dep_coef (E,) float32
    """

    step_ptr: torch.Tensor
    lane_row: torch.Tensor
    lane_cin: torch.Tensor
    lane_cout: torch.Tensor
    lane_dinv: torch.Tensor
    dep_ptr: torch.Tensor
    dep_idx: torch.Tensor
    dep_coef: torch.Tensor
    n: int
    n_carry: int
    max_step_lanes: int

    @property
    def num_steps(self) -> int:
        return int(self.step_ptr.shape[0]) - 1

    @property
    def num_lanes(self) -> int:
        return int(self.lane_row.shape[0])

    @property
    def num_deps(self) -> int:
        return int(self.dep_idx.shape[0])

    def tensors(self) -> tuple:
        return (self.step_ptr, self.lane_row, self.lane_cin, self.lane_cout,
                self.lane_dinv, self.dep_ptr, self.dep_idx, self.dep_coef)

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


def pack_groups(groups, n: int, n_carry: int) -> PackedSchedule:
    """Repack width groups (leaf tuples of numpy arrays or tensors, as in
    `DeviceSchedule.groups`) into the kernel's step-major lane list.

    Within a step, lanes keep group order, then lane order.  A lane is
    dropped when it neither finalizes a row nor writes a carry (padding);
    a dep slot is dropped when its coefficient is 0 (padding slots).
    """
    num_steps = int(_np(groups[0][0]).shape[0]) if groups else 0
    cols = {k: [] for k in ("step", "row", "cin", "cout", "dinv", "cnt",
                            "idx", "coef")}
    for g in groups:
        row = _np(g[0])
        idx, coef, dinv = _np(g[1]), _np(g[2]), _np(g[3])
        if len(g) == 6:
            cin, cout = _np(g[4]), _np(g[5])
        else:
            cin = np.full(row.shape, n_carry, dtype=np.int64)
            cout = np.full(row.shape, n_carry + 1, dtype=np.int64)
        s_i, c_i = np.nonzero((row != n) | (cout != n_carry + 1))
        keep = coef[s_i, c_i] != 0                      # (lanes, D)
        cols["step"].append(s_i)
        cols["row"].append(row[s_i, c_i])
        cols["cin"].append(cin[s_i, c_i])
        cols["cout"].append(cout[s_i, c_i])
        cols["dinv"].append(dinv[s_i, c_i])
        cols["cnt"].append(keep.sum(1))
        cols["idx"].append(idx[s_i, c_i][keep])         # lane-major order
        cols["coef"].append(coef[s_i, c_i][keep])
    cat = {k: (np.concatenate(v) if v else np.zeros(0))
           for k, v in cols.items()}
    order = np.argsort(cat["step"], kind="stable")      # step-major
    cnt = cat["cnt"].astype(np.int64)
    src_start = np.cumsum(cnt) - cnt
    dep_gather = np.repeat(src_start[order], cnt[order]) + \
        _segment_arange(cnt[order])
    lanes_per_step = np.bincount(cat["step"].astype(np.int64),
                                 minlength=num_steps)
    step_ptr = np.zeros(num_steps + 1, dtype=np.int64)
    np.cumsum(lanes_per_step, out=step_ptr[1:])
    dep_ptr = np.zeros(order.size + 1, dtype=np.int64)
    np.cumsum(cnt[order], out=dep_ptr[1:])

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))

    return PackedSchedule(
        step_ptr=i32(step_ptr), lane_row=i32(cat["row"][order]),
        lane_cin=i32(cat["cin"][order]), lane_cout=i32(cat["cout"][order]),
        lane_dinv=f32(cat["dinv"][order]), dep_ptr=i32(dep_ptr),
        dep_idx=i32(cat["idx"][dep_gather]),
        dep_coef=f32(cat["coef"][dep_gather]), n=int(n),
        n_carry=int(n_carry),
        max_step_lanes=int(lanes_per_step.max(initial=0)))


def pack_schedule(sched) -> PackedSchedule:
    """`pack_groups` over a host LevelSchedule's width groups."""
    leaves = tuple(
        (g.row_ids, g.dep_idx, g.dep_coef, g.dinv) +
        ((g.carry_in, g.carry_out) if g.carry_in is not None else ())
        for g in sched.groups)
    return pack_groups(leaves, sched.n, sched.n_carry)


def emulate_packed(packed: PackedSchedule, c_pad: torch.Tensor) \
        -> torch.Tensor:
    """The kernel's per-step loop in torch, on the packed arrays: c_pad
    (n+1,) or (n+1, R) float32.  Returns x (n,) or (n, R)."""
    n, n_carry = packed.n, packed.n_carry
    tail = tuple(c_pad.shape[1:])
    dev = c_pad.device
    p = packed.to(dev)
    step_ptr = p.step_ptr.tolist()
    dep_ptr = p.dep_ptr.long()
    lane_of_dep = torch.repeat_interleave(
        torch.arange(packed.num_lanes, device=dev), dep_ptr.diff())
    x = torch.zeros((n + 1,) + tail, dtype=c_pad.dtype, device=dev)
    carry = torch.zeros((n_carry + 2,) + tail, dtype=c_pad.dtype, device=dev)
    coef = p.dep_coef.to(c_pad.dtype)
    if tail:
        coef = coef[:, None]
    for s in range(packed.num_steps):
        lo, hi = step_ptr[s], step_ptr[s + 1]
        elo, ehi = int(dep_ptr[lo]), int(dep_ptr[hi])
        prod = coef[elo:ehi] * x[p.dep_idx[elo:ehi].long()]
        tot = torch.zeros((hi - lo,) + tail, dtype=c_pad.dtype, device=dev)
        tot.index_add_(0, lane_of_dep[elo:ehi] - lo, prod)
        tot = tot + carry[p.lane_cin[lo:hi].long()]
        row = p.lane_row[lo:hi].long()
        fin = row < n
        dinv = p.lane_dinv[lo:hi].to(c_pad.dtype)[fin]
        if tail:
            dinv = dinv[:, None]
        x[row[fin]] = (c_pad[row[fin]] - tot[fin]) * dinv
        cout = p.lane_cout[lo:hi].long()
        part = cout < n_carry
        carry[cout[part]] = tot[part]
    return x[:n]


def _launch(packed: PackedSchedule, c_pad: torch.Tensor) -> torch.Tensor:
    """Check and launch the CUDA kernel on c_pad (n+1, R) float32."""
    from .build import load_library
    dev = c_pad.device
    if c_pad.dtype != torch.float32:
        raise TypeError(f"the CUDA SpTRSV kernel takes float32, got "
                        f"{c_pad.dtype}")
    if c_pad.ndim != 2 or c_pad.shape[0] != packed.n + 1:
        raise ValueError(f"c_pad must be ({packed.n + 1}, R), got "
                         f"{tuple(c_pad.shape)}")
    if not c_pad.is_contiguous():
        raise ValueError("c_pad must be contiguous")
    for t in packed.tensors():
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"packed schedule must be contiguous on {dev}, "
                             f"got a tensor on {t.device}")
    R = int(c_pad.shape[1])
    x = torch.zeros((packed.n + 1, R), dtype=torch.float32, device=dev)
    carry = torch.zeros((packed.n_carry + 2, R), dtype=torch.float32,
                        device=dev)
    threads = min(MAX_THREADS,
                  max(32, -(-packed.max_step_lanes * R // 32) * 32))
    lib = load_library("sptrsv_level")
    fn = lib.sptrsv_levels_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(t.data_ptr() for t in packed.tensors()), c_pad.data_ptr(),
                 x.data_ptr(), carry.data_ptr(), packed.num_steps, packed.n,
                 packed.n_carry, R, threads, stream)
    if err != 0:
        raise RuntimeError(f"sptrsv_levels_kernel launch failed: CUDA error "
                           f"{err} (threads={threads}, steps="
                           f"{packed.num_steps}, R={R})")
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
    LAUNCHES[key] += 1
    return x[:n]


def _plain(groups, c_pad: torch.Tensor, n: int, n_carry: int) \
        -> torch.Tensor:
    if groups is None:
        raise ValueError("the plain version needs the width groups")
    LAUNCHES["plain"] += 1
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
    schedule streams once for all R columns (one thread per lane and
    column)."""
    if c_pad.ndim != 2:
        raise ValueError(f"sptrsv_groups_multi takes c_pad (n+1, R), got "
                         f"{tuple(c_pad.shape)}")
    if c_pad.device.type == "cpu":
        return _plain(groups, c_pad, n, n_carry)
    return _kernel_solve(groups, c_pad, n, n_carry, packed,
                         "sptrsv_groups_multi")


def sptrsv_levels(row_ids, dep_idx, dep_coef, dinv, carry_in, carry_out,
                  c_ids, c_pad: torch.Tensor, *, n: int,
                  n_carry: int) -> torch.Tensor:
    """K3: single-group compatibility wrapper over K1's kernel (legacy flat
    signature; c_ids is accepted and ignored — row_ids doubles as the c
    gather index).  Its launches count under "sptrsv_levels" only."""
    del c_ids
    if c_pad.ndim != 1:
        raise ValueError(f"sptrsv_levels takes c_pad (n+1,), got "
                         f"{tuple(c_pad.shape)}")
    groups = ((row_ids, dep_idx, dep_coef, dinv, carry_in, carry_out),)
    if c_pad.device.type == "cpu":
        return _plain(groups, c_pad, n, n_carry)
    return _kernel_solve(groups, c_pad.reshape(-1, 1), n, n_carry, None,
                         "sptrsv_levels")[:, 0]
