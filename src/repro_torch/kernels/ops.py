"""Host-level wrapper around the SpTRSV kernels.

Port of `sptrsv_solve` from `repro.kernels.ops`.  The ELL SpMV wrappers
(`spmv_ell`, `ell_pack_csr`) come with the port of that kernel (ROADMAP.md,
queue 2).
"""
from __future__ import annotations

import numpy as np
import torch

from ..solver.engines import default_engine_for
from ..solver.levelset import (pad_rhs, resolve_device, to_device,
                               torch_dtype)
from ..solver.schedule import LevelSchedule
from . import ref

__all__ = ["sptrsv_solve"]


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
