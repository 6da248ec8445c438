"""ELL SpMV on Hopper: the CUDA kernel's wrapper, its packed form and its
emulator.

Replaces the Pallas TPU kernel K4 `spmv_ell_pallas`
(`src/repro/kernels/spmv_ell.py`) with `spmv_ell`: y (n_pad,) =
ELL(A) @ x for row-major ELL arrays as `ops.ell_pack_csr` packs them.

What bounds it on the H100: bytes.  One FMA per slot against an index, a
coefficient and a gathered x entry read per slot, so the product sits far
below the card's operations-per-byte balance.  The row-major ELL is a
poor form to stream on this card: neighbouring rows lie D slots apart,
and every row is padded to the widest.  So the kernel runs on a packed
form of its own, `SlicedEll`, a row-sorted sliced ELL:

* only true padding slots (index `sentinel`, coefficient 0) are dropped;
  each row keeps its other slots in their ELL order;
* rows with at most `LONG_SLOTS` kept slots are stably sorted by kept
  length, longest first, within windows of `SIGMA` rows, and cut into
  slices of 32 rows; a slice is stored column-major (slot d of its 32
  rows is contiguous) and padded to its own widest row with
  (sentinel, 0), so one warp reads each slot step as 128 coalesced bytes
  of index and 128 or 256 of coefficient;
* longer rows go to a CSR-like list (`long_rows`, `long_ptr`, `long_idx`,
  `long_coef`), one warp each;
* every row 0..n_pad-1 lands exactly once, in a slice or in the list, so
  the kernel writes all of y.

All packing and grid arithmetic is here in Python, shared by the launch
(`spmv_sliced`) and by `emulate_sliced`, which runs the kernel's per-warp
loop in torch, so the CPU tests hold the packing.  `pack_sliced` packs
ELL arrays on their device; `pack_sliced_csr` packs the same form from a
CSR on the host, without ever building the (n_pad, D) arrays.  The TPU
wrapper's rounding of x_pad to a multiple of 128 is a TPU tiling detail
and is not carried over: the kernel reads x_pad as the caller gives it.

Dispatch: CPU tensors run the plain version (`kernels/ref.py`) and count
under "plain"; CUDA tensors take the packed form kept for the same
tensor objects at the same versions (else pack now) and launch the
kernel, or raise.  `LAUNCHES` counts each, atomically across threads
(`kernels.counts.Counts`); `SLICE_PACKS` counts packs and cache hits.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import threading
import weakref

import numpy as np
import torch

from . import ref
from .counts import Counts

__all__ = ["spmv_ell", "spmv_sliced", "SlicedEll", "pack_sliced",
           "pack_sliced_csr", "emulate_sliced", "sliced_for", "LAUNCHES",
           "SLICE_PACKS", "SIGMA", "LONG_SLOTS", "reset_launch_counts"]

# launches of the kernel, and of the plain version taken for CPU tensors
LAUNCHES = Counts("spmv_ell", "plain")
# packs of the sliced form by `sliced_for`, and lookups that found one kept
SLICE_PACKS = Counts("packs", "hits")

LANES = 32          # rows of a slice: one warp, a lane per row
SIGMA = 256         # rows of a sorting window
LONG_SLOTS = 32     # rows with more kept slots take a warp of their own

_ENTRY = {torch.float32: "spmv_ell_f32_launch",
          torch.float64: "spmv_ell_f64_launch"}
_SIGNATURES = {name: [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2 +
               [ctypes.c_void_p] for name in _ENTRY.values()}


def reset_launch_counts() -> None:
    LAUNCHES.reset()


@dataclasses.dataclass
class SlicedEll:
    """The kernel's packed form of an ELL matrix (module docstring).

    Slice s holds slots slice_ptr[s]..slice_ptr[s+1] of `idx`/`coef`,
    32 x its width, column-major: slot d of lane i at slice_ptr[s] +
    32 d + i.  Lane i of slice s writes y[row_of[32 s + i]] (-1: no row).
    Long row j (y row long_rows[j]) holds slots long_ptr[j]..long_ptr[j+1]
    of `long_idx`/`long_coef`.  Offsets and indices are int32."""
    n_rows: int
    sentinel: int
    slice_ptr: torch.Tensor
    row_of: torch.Tensor
    idx: torch.Tensor
    coef: torch.Tensor
    long_rows: torch.Tensor
    long_ptr: torch.Tensor
    long_idx: torch.Tensor
    long_coef: torch.Tensor
    kept: int           # real slots: the ELL's less its true padding
    sigma: int = SIGMA
    long_slots: int = LONG_SLOTS

    @property
    def num_slices(self) -> int:
        return self.slice_ptr.shape[0] - 1

    @property
    def num_long(self) -> int:
        return self.long_rows.shape[0]

    @property
    def slots(self) -> int:
        """Slots stored, slice padding included."""
        return self.idx.shape[0] + self.long_idx.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.coef.dtype

    @property
    def device(self) -> torch.device:
        return self.coef.device

    def to(self, device) -> "SlicedEll":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    def kernel_args(self) -> tuple:
        """The packed arrays' eight device pointers, in the launch's C
        order (taken once: the packed tensors are never written after the
        pack)."""
        args = self.__dict__.get("_args")
        if args is None:
            args = self.__dict__["_args"] = (
                self.slice_ptr.data_ptr(), self.row_of.data_ptr(),
                self.idx.data_ptr(), self.coef.data_ptr(),
                self.long_rows.data_ptr(), self.long_ptr.data_ptr(),
                self.long_idx.data_ptr(), self.long_coef.data_ptr())
        return args


def _offsets(lengths: torch.Tensor) -> torch.Tensor:
    """(k + 1,) int64 exclusive prefix sums of `lengths`."""
    out = torch.zeros(lengths.shape[0] + 1, dtype=torch.int64,
                      device=lengths.device)
    torch.cumsum(lengths, 0, out=out[1:])
    return out


def _assemble(klen: torch.Tensor, slot_row: torch.Tensor,
              slot_rank: torch.Tensor, slot_idx: torch.Tensor,
              slot_coef: torch.Tensor, sentinel: int, sigma: int,
              long_slots: int) -> SlicedEll:
    """The sliced form from each row's kept length (n_rows,) and each kept
    slot's row, rank within its row, index and coefficient (all on one
    device; int64 but for slot_idx int32)."""
    if sigma < 1 or long_slots < 0:
        raise ValueError(f"sigma must be >= 1 and long_slots >= 0, got "
                         f"{sigma}, {long_slots}")
    dev = klen.device
    n_rows = klen.shape[0]
    is_long = klen > long_slots
    short = torch.nonzero(~is_long).squeeze(1)
    # stable sort by (window, longest first): kept lengths are <= long_slots
    key = (short // sigma) * (long_slots + 1) + (long_slots - klen[short])
    rows = short[torch.sort(key, stable=True).indices]
    n_short = rows.shape[0]
    n_slices = -(-n_short // LANES)
    lane_len = torch.zeros(n_slices * LANES, dtype=torch.int64, device=dev)
    lane_len[:n_short] = klen[rows]
    width = lane_len.view(n_slices, LANES).amax(1)
    slice_ptr = _offsets(LANES * width)
    row_of = torch.full((n_slices * LANES,), -1, dtype=torch.int32,
                        device=dev)
    row_of[:n_short] = rows.to(torch.int32)
    lane = torch.arange(n_short, device=dev)
    base = torch.full((n_rows,), -1, dtype=torch.int64, device=dev)
    base[rows] = slice_ptr[lane // LANES] + lane % LANES

    long_rows = torch.nonzero(is_long).squeeze(1)
    long_ptr = _offsets(klen[long_rows])
    lbase = torch.full((n_rows,), -1, dtype=torch.int64, device=dev)
    lbase[long_rows] = long_ptr[:-1]

    if slot_idx.numel() and (int(slot_idx.min()) < 0
                             or int(slot_idx.max()) > sentinel):
        raise ValueError(f"an ELL index lies outside x_pad's 0..{sentinel}: "
                         f"the kernel would read out of bounds")
    total, n_long_slots = int(slice_ptr[-1]), int(long_ptr[-1])
    # the kernel's unrolled loops step up to 8 x 32 slots past an offset
    if max(total, n_long_slots, n_rows, sentinel + 1) >= 2 ** 31 - 8 * LANES:
        raise ValueError("the sliced ELL kernel takes int32 offsets")
    in_long = is_long[slot_row]
    idx = torch.full((total,), sentinel, dtype=torch.int32, device=dev)
    coef = torch.zeros(total, dtype=slot_coef.dtype, device=dev)
    at = base[slot_row] + LANES * slot_rank
    short_slot = ~in_long
    idx[at[short_slot]] = slot_idx[short_slot]
    coef[at[short_slot]] = slot_coef[short_slot]
    long_idx = torch.empty(n_long_slots, dtype=torch.int32, device=dev)
    long_coef = torch.empty(n_long_slots, dtype=slot_coef.dtype, device=dev)
    lat = lbase[slot_row[in_long]] + slot_rank[in_long]
    long_idx[lat] = slot_idx[in_long]
    long_coef[lat] = slot_coef[in_long]
    return SlicedEll(n_rows=n_rows, sentinel=sentinel,
                     slice_ptr=slice_ptr.to(torch.int32), row_of=row_of,
                     idx=idx, coef=coef,
                     long_rows=long_rows.to(torch.int32),
                     long_ptr=long_ptr.to(torch.int32), long_idx=long_idx,
                     long_coef=long_coef, kept=slot_row.shape[0],
                     sigma=sigma, long_slots=long_slots)


def pack_sliced(ell_idx: torch.Tensor, ell_coef: torch.Tensor,
                sentinel: int, *, sigma: int = SIGMA,
                long_slots: int = LONG_SLOTS) -> SlicedEll:
    """The sliced form of ELL arrays (n_pad, D), built with torch ops on
    their device; `sentinel` = x_pad.shape[0] - 1.  A slot is dropped only
    if it is true padding: index `sentinel` and coefficient 0."""
    keep = (ell_idx != sentinel) | (ell_coef != 0)
    klen = keep.sum(1)
    slot_row, slot_col = torch.nonzero(keep, as_tuple=True)  # ELL order
    start = _offsets(klen)[:-1]
    slot_rank = torch.arange(slot_row.shape[0], device=keep.device) - \
        start[slot_row]
    return _assemble(klen, slot_row, slot_rank,
                     ell_idx[slot_row, slot_col].to(torch.int32),
                     ell_coef[slot_row, slot_col], int(sentinel), sigma,
                     long_slots)


def pack_sliced_csr(m, dtype=np.float32, *, block_rows: int = 512,
                    sigma: int = SIGMA,
                    long_slots: int = LONG_SLOTS) -> SlicedEll:
    """The sliced form of CSR `m` on the host (CPU tensors), equal array
    for array to `pack_sliced` of `ops.ell_pack_csr(m, block_rows, dtype)`
    with sentinel m.n_cols, but without building the (n_pad, D) arrays."""
    n = m.n_rows
    n_pad = -(-n // block_rows) * block_rows
    indptr = np.asarray(m.indptr, dtype=np.int64)
    deg = np.diff(indptr)
    klen = np.zeros(n_pad, dtype=np.int64)
    klen[:n] = deg
    slot_row = np.repeat(np.arange(n, dtype=np.int64), deg)
    slot_rank = np.arange(indptr[-1], dtype=np.int64) - \
        np.repeat(indptr[:-1], deg)
    return _assemble(
        torch.from_numpy(klen), torch.from_numpy(slot_row),
        torch.from_numpy(slot_rank),
        torch.from_numpy(np.asarray(m.indices, dtype=np.int32)),
        torch.from_numpy(np.asarray(m.data, dtype=dtype)), int(m.n_cols),
        sigma, long_slots)


def emulate_sliced(packed: SlicedEll, x_pad: torch.Tensor) -> torch.Tensor:
    """The kernel's per-warp loop in torch: each slice lane sums its slots
    in order with one accumulator, each long-row lane sums slots lane,
    lane + 32, ... and the warp adds its lanes by the kernel's xor tree.
    Returns y (n_rows,) in the packed dtype; a row that no lane writes
    stays NaN."""
    dtype = packed.dtype
    x = x_pad.to(dtype)
    y = torch.full((packed.n_rows,), float("nan"), dtype=dtype,
                   device=x.device)
    lane = torch.arange(LANES, device=x.device)
    ptr = packed.slice_ptr.long()
    width = (ptr[1:] - ptr[:-1]) // LANES
    acc = torch.zeros((packed.num_slices, LANES), dtype=dtype,
                      device=x.device)
    for d in range(int(width.max()) if packed.num_slices else 0):
        act = torch.nonzero(width > d).squeeze(1)
        at = ptr[act, None] + LANES * d + lane
        acc[act] += packed.coef[at] * x[packed.idx[at].long()]
    rows = packed.row_of.long().view(-1, LANES)
    y[rows[rows >= 0]] = acc[rows >= 0]
    if packed.num_long:
        lptr = packed.long_ptr.long()
        lacc = torch.zeros((packed.num_long, LANES), dtype=dtype,
                           device=x.device)
        for k in range(0, int((lptr[1:] - lptr[:-1]).max()), LANES):
            at = lptr[:-1, None] + k + lane
            live = at < lptr[1:, None]
            at = torch.where(live, at, 0)
            term = packed.long_coef[at] * x[packed.long_idx[at].long()]
            lacc = torch.where(live, lacc + term, lacc)
        for o in (16, 8, 4, 2, 1):
            lacc = lacc + lacc[:, lane ^ o]
        y[packed.long_rows.long()] = lacc[:, 0]
    return y


_SLICED = collections.OrderedDict()   # key -> (weakrefs, packed)
_SLICED_KEEP = 8
_SLICED_LOCK = threading.Lock()


def sliced_for(ell_idx: torch.Tensor, ell_coef: torch.Tensor,
               sentinel: int) -> SlicedEll:
    """The sliced form packed for the same tensor objects at the same
    versions (no in-place write since; among the last _SLICED_KEEP), else
    packed now, on the arrays' device."""
    key = (id(ell_idx), ell_idx._version, id(ell_coef), ell_coef._version,
           sentinel)
    with _SLICED_LOCK:
        hit = _SLICED.pop(key, None)
        if hit is not None and hit[0][0]() is ell_idx \
                and hit[0][1]() is ell_coef:
            _SLICED[key] = hit
            SLICE_PACKS.add("hits")
            return hit[1]
    packed = pack_sliced(ell_idx, ell_coef, sentinel)
    SLICE_PACKS.add("packs")
    with _SLICED_LOCK:
        _SLICED[key] = ((weakref.ref(ell_idx), weakref.ref(ell_coef)),
                        packed)
        while len(_SLICED) > _SLICED_KEEP:
            _SLICED.popitem(last=False)
    return packed


def _check(ell_idx: torch.Tensor, ell_coef: torch.Tensor,
           x_pad: torch.Tensor) -> None:
    if ell_idx.ndim != 2 or ell_coef.shape != ell_idx.shape:
        raise ValueError(f"ell_idx and ell_coef must both be (n_pad, D), got "
                         f"{tuple(ell_idx.shape)} and "
                         f"{tuple(ell_coef.shape)}")
    if x_pad.ndim != 1 or x_pad.shape[0] < 1:
        raise ValueError(f"x_pad must be (n+1,), got {tuple(x_pad.shape)}")
    if ell_idx.dtype != torch.int32:
        raise TypeError(f"ell_idx must be int32, got {ell_idx.dtype}")
    if ell_coef.dtype not in _ENTRY:
        raise TypeError(f"ell_coef must be float32 or float64, got "
                        f"{ell_coef.dtype}")
    if not (ell_idx.device == ell_coef.device == x_pad.device):
        raise ValueError(f"ell_idx, ell_coef and x_pad must lie on one "
                         f"device, got {ell_idx.device}, {ell_coef.device}, "
                         f"{x_pad.device}")


def _entry(dtype: torch.dtype):
    """The library's entry point for `dtype`, built and bound on first
    use, so a launch does not configure its ctypes function again."""
    from .build import entry_points
    return entry_points("spmv_ell", _SIGNATURES)[_ENTRY[dtype]]


def spmv_sliced(packed: SlicedEll, x_pad: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on a packed form on the card: y (n_rows,) in the
    packed dtype, x_pad (sentinel + 1,) cast to it.  Counts one launch."""
    dev = packed.device
    if dev.type != "cuda":
        raise ValueError(f"spmv_sliced launches the CUDA kernel; the packed "
                         f"form lies on {dev} (emulate_sliced runs its "
                         f"loop on the CPU)")
    if x_pad.device != dev:
        raise ValueError(f"x_pad lies on {x_pad.device}, the packed form on "
                         f"{dev}")
    if x_pad.shape != (packed.sentinel + 1,):
        raise ValueError(f"x_pad must be ({packed.sentinel + 1},), got "
                         f"{tuple(x_pad.shape)}")
    dtype = packed.dtype
    if x_pad.dtype != dtype:
        x_pad = x_pad.to(dtype)
    if not x_pad.is_contiguous():
        raise ValueError("x_pad must be contiguous")
    y = torch.empty(packed.n_rows, dtype=dtype, device=dev)
    fn = _entry(dtype)
    args = packed.kernel_args() + (x_pad.data_ptr(), y.data_ptr(),
                                   packed.num_slices, packed.num_long)
    if dev.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"spmv_ell_kernel launch failed: CUDA error {err} "
                           f"(n_rows={packed.n_rows}, slices="
                           f"{packed.num_slices}, long={packed.num_long}, "
                           f"{packed.dtype})")
    LAUNCHES.add("spmv_ell")
    return y


def spmv_ell(ell_idx: torch.Tensor, ell_coef: torch.Tensor,
             x_pad: torch.Tensor) -> torch.Tensor:
    """K4: y (n_pad,) = ELL(A) @ x, in ell_coef's dtype.

    ell_idx (n_pad, D) int32 and ell_coef (n_pad, D) float32/float64, with
    padding slots indexing the last entry of x_pad at coefficient 0;
    x_pad (n+1,) with a zero last entry, cast to ell_coef's dtype as the
    TPU wrapper casts it.  CPU tensors take the plain version; CUDA
    tensors launch the kernel on their sliced form (`sliced_for`).
    """
    _check(ell_idx, ell_coef, x_pad)
    x_pad = x_pad.to(ell_coef.dtype)
    if ell_coef.device.type == "cpu":
        LAUNCHES.add("plain")
        return ref.spmv_ell_ref(ell_idx, ell_coef, x_pad)
    return spmv_sliced(sliced_for(ell_idx, ell_coef, x_pad.shape[0] - 1),
                       x_pad)
