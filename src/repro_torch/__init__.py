"""PyTorch/CUDA port of the SpTRSV graph-transformation system.

Mirrors `repro`'s sub-packages: `sparse` and `core` (numpy host half,
copied), `solver` (schedule compiler copy, device staging, engines, the
cached operator) and `kernels` (hand-written CUDA kernels for Hopper and
their plain PyTorch versions).  Imports torch, numpy and scipy only.
"""
from .solver import TriangularOperator

__all__ = ["TriangularOperator"]
