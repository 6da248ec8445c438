"""`sptrsv`: the one-call triangular-solve surface (forward, backward, grad).

Port of `repro.solver.api`.  All four sweeps through a single function:

    x = sptrsv(L, b)                                  # L x = b
    y = sptrsv(L, x, transpose=True)                  # L^T y = x
    z = sptrsv(U, b, lower=False)                     # U z = b
    w = sptrsv(U, b, lower=False, transpose=True)     # U^T w = b

Every call builds (or cache-hits) a `TriangularOperator` with the matching
orientation bits, on the card unless the caller passes `device="cpu"`, so
repeat calls on the same matrix and configuration skip straight to the
compiled schedule.

Differentiability: a torch tensor `b` goes through a
`torch.autograd.Function` whose forward is the operator's refined host
solve (the reference runs it inside `jax.pure_callback`) and whose
backward is *the transpose operator itself* — the cotangent of
`x = A^{-1} b` is `b_bar = A^{-T} g` — routed back through the same
Function, so the backward pass is differentiable too (`create_graph=True`,
second-order gradients).  Gradients flow through `b`; the matrix is not
differentiable.  The result has `b`'s dtype and lies on `b`'s device,
whichever device the operator serves from; a numpy `b` returns float64
numpy.

`mesh=` (a torch.distributed DeviceMesh, with `mesh_axis=`) builds the
operator under the sharded engine (one all_gather family per schedule
step); the backward pass solves the flipped system under the same mesh.
Every rank calls `sptrsv` with the same b and gets the same x.
"""
from __future__ import annotations

import numpy as np
import torch

from ..sparse.csr import CSR, from_coo
from .operator import TriangularOperator

__all__ = ["sptrsv", "with_unit_diagonal"]


def with_unit_diagonal(A: CSR) -> CSR:
    """A with its diagonal forced to 1 (existing entries replaced, missing
    ones inserted) — the `unit_diagonal=True` semantics of sptrsv, matching
    scipy.sparse.linalg.spsolve_triangular."""
    n = min(A.shape)
    rows = np.repeat(np.arange(A.n_rows), A.row_nnz())
    off = rows != A.indices
    rows = np.concatenate([rows[off], np.arange(n)])
    cols = np.concatenate([A.indices[off], np.arange(n)])
    vals = np.concatenate([A.data[off], np.ones(n, dtype=A.data.dtype)])
    return from_coo(rows, cols, vals, A.shape, sum_duplicates=False)


class _BoundSolve:
    """Forward/adjoint operator pair closed over solve options.

    The adjoint operator is built lazily on the first backward pass
    (from_csr, so it shares the operator cache).
    """

    def __init__(self, op: TriangularOperator, refine_tol: float,
                 max_refine: int, health=None):
        self.op = op
        self.refine_tol = refine_tol
        self.max_refine = max_refine
        self.health = health
        self._adjoint = None
        self._flipped = None

    @property
    def adjoint(self) -> TriangularOperator:
        if self._adjoint is None:
            self._adjoint = self.op.transposed()
        return self._adjoint

    def flipped(self) -> "_BoundSolve":
        """The adjoint solve as its own _BoundSolve, whose adjoint is this
        one's forward op — so the backward pass is itself differentiable
        (grad-of-grad composes to any order)."""
        if self._flipped is None:
            f = _BoundSolve(self.adjoint, self.refine_tol, self.max_refine,
                            health=self.health)
            f._adjoint = self.op
            f._flipped = self
            self._flipped = f
        return self._flipped

    def host_solve(self, b: np.ndarray) -> np.ndarray:
        # the operator promotes b itself when refining; with refinement
        # off it runs in the schedule dtype and only the returned array is
        # cast up — sptrsv's numpy path contract is float64 out either way
        x = self.op.solve(np.asarray(b), refine_tol=self.refine_tol,
                          max_refine=self.max_refine, health=self.health)
        return np.asarray(x, dtype=np.float64)

    def tensor_solve(self, b: torch.Tensor) -> torch.Tensor:
        """host_solve of a tensor: b's dtype, on b's device."""
        x = self.host_solve(b.detach().cpu().numpy())
        return torch.as_tensor(np.ascontiguousarray(x), dtype=b.dtype,
                               device=b.device)


class _Solve(torch.autograd.Function):
    """x = op^{-1} b with the flipped solve as its backward."""

    @staticmethod
    def forward(ctx, bound: _BoundSolve, b: torch.Tensor) -> torch.Tensor:
        ctx.bound = bound           # cotangent needs no saved tensors
        return bound.tensor_solve(b)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        # d/db of x = A^{-1} b contracted with g is A^{-T} g: the forward
        # surface with the transpose bit flipped, through this Function so
        # that the cotangent is itself differentiable
        return None, _Solve.apply(ctx.bound.flipped(), g)


def sptrsv(A: CSR, b, *, lower: bool = True, transpose: bool = False,
           unit_diagonal: bool = False, engine=None, device=None, mesh=None,
           mesh_axis: str = "model", tune="no_rewriting", chunk: int = 256,
           max_deps: int = 16,
           dtype=np.float32, cache: bool = True, cache_dir=None,
           refine_tol: float = 1e-10, max_refine: int = 6, health=None):
    """Solve the triangular system `op(A) x = b` (module doc for the map
    of sweeps).

    A:      CSR triangular matrix — lower when `lower=True`, else upper.
    b:      (n,) or batched (n, k).  A numpy array returns float64 numpy
            (refined by default; with max_refine=0 the device math runs in
            the schedule dtype and only the returned array is cast up); a
            torch tensor returns a tensor of its dtype on its device, and
            is differentiable w.r.t. b.
    lower/transpose/unit_diagonal: orientation of the solve, matching
            scipy.sparse.linalg.spsolve_triangular's vocabulary.
    engine: registered engine name, Engine instance, or None (the device's
            default: "cuda" on a card, "torch" on the CPU).
    device: where the operator lives: "cuda" (the default when None) or
            "cpu"; b is copied there and the result comes back to b's
            device.
    mesh/mesh_axis: a DeviceMesh routes the solve (and its backward)
            through the sharded engine over `mesh_axis`, on the mesh's
            device (module doc).  Mutually exclusive with engine=.
    tune:   transform selection forwarded to TriangularOperator.from_csr —
            "no_rewriting" (default: plain level scheduling), any stable
            strategy name, a Strategy instance, or "auto" for the
            portfolio auto-tuner.
    cache/cache_dir: reuse/persist the compiled operator artifact across
            calls (TriangularOperator.from_csr).
    health: solve-path health policy — a HealthPolicy, a named level
            ("off" | "on" | "strict" | "repair" | "fallback"), or None for
            the REPRO_HEALTH_CHECKS environment default
            (TriangularOperator.solve).  Applies to every solve this call
            performs, backward (adjoint) passes included.
    """
    if unit_diagonal:
        A = with_unit_diagonal(A)
    op = TriangularOperator.from_csr(
        A, tune, side="lower" if lower else "upper",
        transpose=bool(transpose), chunk=chunk, max_deps=max_deps,
        dtype=dtype, engine=engine, device=device, mesh=mesh,
        mesh_axis=mesh_axis, cache=cache, cache_dir=cache_dir)
    bound = _BoundSolve(op, refine_tol=refine_tol, max_refine=max_refine,
                        health=health)
    if isinstance(b, torch.Tensor):
        return _Solve.apply(bound, b)
    return bound.host_solve(np.asarray(b))
