"""ELL SpMV on Hopper: the CUDA kernel's wrapper.

Replaces the Pallas TPU kernel K4 `spmv_ell_pallas`
(`src/repro/kernels/spmv_ell.py`) with `spmv_ell`: y (n_pad,) =
ELL(A) @ x for row-major ELL arrays as `ops.ell_pack_csr` packs them.

What bounds it on the H100: bytes.  One FMA per slot against an index, a
coefficient and a gathered x entry read per slot, so the product sits far
below the card's operations-per-byte balance.  The kernel
(`csrc/spmv_ell.cu`) runs one thread per row; its design notes are in the
source.  The TPU wrapper's rounding of x_pad to a multiple of 128 is a
TPU tiling detail and is not carried over: the kernel reads x_pad as the
caller gives it.

Dispatch: CPU tensors run the plain version (`kernels/ref.py`) and count
under "plain"; CUDA tensors launch the kernel or raise.  `LAUNCHES`
counts each, atomically across threads (`kernels.counts.Counts`).
"""
from __future__ import annotations

import ctypes

import torch

from . import ref
from .counts import Counts

__all__ = ["spmv_ell", "LAUNCHES", "reset_launch_counts"]

# launches of the kernel, and of the plain version taken for CPU tensors
LAUNCHES = Counts("spmv_ell", "plain")

_ENTRY = {torch.float32: "spmv_ell_f32_launch",
          torch.float64: "spmv_ell_f64_launch"}
_SIGNATURES = {name: [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 +
               [ctypes.c_void_p] for name in _ENTRY.values()}


def reset_launch_counts() -> None:
    LAUNCHES.reset()


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


def _launch(ell_idx: torch.Tensor, ell_coef: torch.Tensor,
            x_pad: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel; x_pad already in ell_coef's dtype."""
    for name, t in (("ell_idx", ell_idx), ("ell_coef", ell_coef),
                    ("x_pad", x_pad)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_rows, D = (int(s) for s in ell_idx.shape)
    if n_rows * D >= 2 ** 31 or x_pad.shape[0] >= 2 ** 31:
        raise ValueError("the ELL kernel takes int32 sizes")
    dev = ell_coef.device
    y = torch.empty(n_rows, dtype=ell_coef.dtype, device=dev)
    fn = _entry(ell_coef.dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ell_idx.data_ptr(), ell_coef.data_ptr(), x_pad.data_ptr(),
                 y.data_ptr(), n_rows, D, stream)
    if err != 0:
        raise RuntimeError(f"spmv_ell_kernel launch failed: CUDA error {err} "
                           f"(n_rows={n_rows}, D={D}, {ell_coef.dtype})")
    LAUNCHES.add("spmv_ell")
    return y


def spmv_ell(ell_idx: torch.Tensor, ell_coef: torch.Tensor,
             x_pad: torch.Tensor) -> torch.Tensor:
    """K4: y (n_pad,) = ELL(A) @ x, in ell_coef's dtype.

    ell_idx (n_pad, D) int32 and ell_coef (n_pad, D) float32/float64, with
    padding slots indexing the last entry of x_pad at coefficient 0;
    x_pad (n+1,) with a zero last entry, cast to ell_coef's dtype as the
    TPU wrapper casts it.  CPU tensors take the plain version; CUDA
    tensors launch the kernel.
    """
    _check(ell_idx, ell_coef, x_pad)
    x_pad = x_pad.to(ell_coef.dtype)
    if ell_coef.device.type == "cpu":
        LAUNCHES.add("plain")
        return ref.spmv_ell_ref(ell_idx, ell_coef, x_pad)
    return _launch(ell_idx, ell_coef, x_pad)
