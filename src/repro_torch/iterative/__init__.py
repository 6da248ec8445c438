"""Iterative solvers: Krylov solvers on torch tensors.

Port of `repro.iterative`: `cg`, `bicgstab` and restarted `gmres` over any
`(matvec, preconditioner)` pair, with the transformed SpTRSV serving as
the preconditioner's kernel:

    from repro_torch.iterative import cg
    from repro_torch.precond import Preconditioner

    P = Preconditioner.ic0(A)                         # tuned pair
    res = cg(A, b, preconditioner=P, tol=1e-8)       # b: (n,) or (n, k)
"""
from .krylov import SolveResult, bicgstab, cg, gmres
from .operators import (as_matvec, as_preconditioner, device_matvec,
                        solve_callback)

__all__ = [
    "SolveResult", "cg", "bicgstab", "gmres",
    "as_matvec", "as_preconditioner", "device_matvec", "solve_callback",
]
