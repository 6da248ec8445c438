"""Plain PyTorch versions of the SpTRSV kernels (numerics ground truth).

Port of `repro.kernels.ref` (`sptrsv_levels_grouped_ref`,
`sptrsv_levels_ref`).  The CPU tests run these, and `chip_smoke.py` holds
the CUDA kernels of `kernels/sptrsv_level.py` against them on the card.
"""
from __future__ import annotations

import torch

from ..solver.levelset import solve_levels

__all__ = ["sptrsv_levels_ref", "sptrsv_levels_grouped_ref"]


def sptrsv_levels_grouped_ref(groups, c_pad: torch.Tensor, n: int,
                              n_carry: int) -> torch.Tensor:
    """Reference for the width-bucketed level-scheduled SpTRSV kernel.

    `groups` is a tuple of per-group leaf tuples: (row_ids (S, C_g),
    dep_idx (S, C_g, D_g), dep_coef, dinv[, carry_in, carry_out]); groups
    without carry maps hold no partial-row lanes.  c_pad has n+1 entries
    (last = 0), or shape (n + 1, R) for batched multi-RHS.  Returns x (n,)
    or (n, R).
    """
    return solve_levels(groups, c_pad, n, n_carry)


def sptrsv_levels_ref(row_ids, dep_idx, dep_coef, dinv, carry_in, carry_out,
                      c_ids, c_pad: torch.Tensor, n: int,
                      n_carry: int) -> torch.Tensor:
    """Single-group compatibility oracle (legacy flat signature; c_ids is
    accepted and ignored — row_ids doubles as the c gather index)."""
    del c_ids
    group = (row_ids, dep_idx, dep_coef, dinv, carry_in, carry_out)
    return sptrsv_levels_grouped_ref((group,), c_pad, n=n, n_carry=n_carry)
