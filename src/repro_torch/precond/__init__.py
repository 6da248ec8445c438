"""Preconditioning: numeric incomplete factorization + facade.

Port of `repro.precond`.  The factors feed the port's triangular-solve
operators, so both sweeps of every M^-1 run through the SpTRSV kernel on
the card:

    from repro_torch.precond import Preconditioner, ic0, ilu0

    P = Preconditioner.ic0(A)        # factor, tune the pair, operators
    z = P(r)                         # z = M^-1 r (numpy or torch tensor)

`ic0`/`ilu0` alone return the raw factors (FactorResult).  The consumer
side lives in `repro_torch.iterative`.
"""
from .api import IdentityPreconditioner, Preconditioner
from .factorize import (FactorResult, FactorizationBreakdown, ic0, ilu0,
                        refactor)

__all__ = [
    "Preconditioner", "IdentityPreconditioner",
    "FactorResult", "FactorizationBreakdown", "ic0", "ilu0", "refactor",
]
