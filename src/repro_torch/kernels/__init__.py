"""Kernels: CUDA for Hopper, with their plain PyTorch versions.

`sptrsv_level` holds K1-K3 (level-scheduled SpTRSV), `spmv_ell` holds K4
(ELL SpMV); `ops` has the host-level entry points over both.
"""
from . import ops, ref, spmv_ell
from .sptrsv_level import (LAUNCHES, sptrsv_groups, sptrsv_groups_multi,
                           sptrsv_levels)
