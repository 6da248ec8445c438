"""SpTRSV kernels: CUDA for Hopper, with their plain PyTorch versions."""
from . import ops, ref
from .sptrsv_level import (LAUNCHES, sptrsv_groups, sptrsv_groups_multi,
                           sptrsv_levels)
