"""PyTorch/CUDA port of the SpTRSV graph-transformation system.

Mirrors `repro`'s sub-packages: `sparse` and `core` (numpy host half,
copied), `solver` (schedule compiler copy, device staging, engines, the
cached operator), `kernels` (hand-written CUDA kernels for Hopper and
their plain PyTorch versions) and the LM stack (`configs`, `models`,
`launch`).  Imports torch, numpy and scipy only.  `TriangularOperator`
is loaded at first use, so that the LM stack does not load the solver.
"""

__all__ = ["TriangularOperator"]


def __getattr__(name):
    if name == "TriangularOperator":
        from .solver import TriangularOperator
        return TriangularOperator
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
