"""Host-level wrappers around the kernels.

Port of `repro.kernels.ops`: `sptrsv_solve` over the SpTRSV kernels
(K1/K2), and `ell_pack_csr` + `spmv_ell` over the ELL SpMV kernel (K4),
which on a card packs the CSR straight into the kernel's sliced form.
Each takes the port's `device=` (None = the CUDA card, raising without
one); on the CPU the kernel wrappers run their plain versions.
"""
from __future__ import annotations

import numpy as np
import torch

from ..solver.engines import default_engine_for
from ..solver.levelset import (pad_rhs, resolve_device, to_device,
                               torch_dtype)
from ..solver.schedule import LevelSchedule
from . import ref
from .spmv_ell import pack_sliced_csr, spmv_sliced
from .spmv_ell import spmv_ell as spmv_ell_kernel

__all__ = ["sptrsv_solve", "spmv_ell", "ell_pack_csr"]


def sptrsv_solve(sched: LevelSchedule, c: np.ndarray, *, device=None,
                 use_ref: bool = False, dsched=None) -> np.ndarray:
    """Solve a LevelSchedule with the kernel (or its plain version).

    c may be (n,) or batched (n, R) — batched solves run the multi-RHS
    kernel, streaming the schedule once for all right-hand sides.  `device`
    follows the port's rule (None = the CUDA card, raising without one);
    on the CPU the kernel wrapper runs its plain version.  Pass a staged
    DeviceSchedule as `dsched` to skip restaging on repeated solves.
    """
    ds = dsched if dsched is not None else \
        to_device(sched, resolve_device(device))
    cc = torch.as_tensor(np.ascontiguousarray(c),
                         dtype=torch_dtype(sched.dtype), device=ds.device)
    if use_ref:
        out = ref.sptrsv_levels_grouped_ref(ds.groups, pad_rhs(cc),
                                            n=sched.n, n_carry=sched.n_carry)
    else:
        out = default_engine_for(ds.device).compile(ds)(cc)
    return out.cpu().numpy()


def ell_pack_csr(m, block_rows: int = 512, dtype=np.float32):
    """Pack a CSR matrix into ELL arrays for spmv_ell (vectorized scatter).

    Returns (ell_idx (n_pad, D), ell_coef (n_pad, D), n) as numpy arrays.
    Padding indices point at x_pad's final zero slot.
    """
    n = m.n_rows
    deg = m.row_nnz()
    D = max(int(deg.max()), 1)
    n_pad = -(-n // block_rows) * block_rows
    ell_idx = np.full((n_pad, D), m.n_cols, dtype=np.int32)
    ell_coef = np.zeros((n_pad, D), dtype=dtype)
    indptr = np.asarray(m.indptr, dtype=np.int64)
    flat = np.repeat(np.arange(n, dtype=np.int64) * D, deg) + \
        (np.arange(indptr[-1]) - np.repeat(indptr[:-1], deg))
    ell_idx.reshape(-1)[flat] = m.indices
    ell_coef.reshape(-1)[flat] = m.data
    return ell_idx, ell_coef, n


def spmv_ell(m, x, *, device=None, use_ref: bool = False,
             block_rows: int = 512):
    """y = m @ x via the ELL kernel (K4), in float32 as the reference's.

    x is a numpy array or a torch tensor of m.n_cols entries.  A tensor
    stays on its device and a tensor comes back; a numpy x goes to
    `device` (None = the CUDA card, raising without one) and a numpy y
    comes back.  The matrix is packed on the host at every call: on a
    card straight into the kernel's sliced form (`pack_sliced_csr`, no
    (n_pad, D) arrays), elsewhere into ELL arrays for the plain version.
    use_ref=True runs the plain version on that device.
    """
    is_tensor = isinstance(x, torch.Tensor)
    if is_tensor:
        dev = x.device
        if device is not None and torch.device(device).type != dev.type:
            raise ValueError(f"x lies on {dev}, not on {device}")
    else:
        dev = resolve_device(device)
    xt = torch.as_tensor(x, dtype=torch.float32, device=dev)
    if xt.shape != (m.n_cols,):
        raise ValueError(f"x must be ({m.n_cols},), got {tuple(xt.shape)}")
    x_pad = pad_rhs(xt)
    if dev.type == "cuda" and not use_ref:
        packed = pack_sliced_csr(m, block_rows=block_rows).to(dev)
        y = spmv_sliced(packed, x_pad)[:m.n_rows]
    else:
        ell_idx, ell_coef, n = ell_pack_csr(m, block_rows=block_rows)
        idx = torch.from_numpy(ell_idx).to(dev)
        coef = torch.from_numpy(ell_coef).to(dev)
        y = (ref.spmv_ell_ref(idx, coef, x_pad) if use_ref
             else spmv_ell_kernel(idx, coef, x_pad))[:n]
    return y if is_tensor else y.cpu().numpy()
