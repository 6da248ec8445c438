"""Adapters turning the port's objects into the callables Krylov solvers
consume.

Port of `repro.iterative.operators`.  The solvers in `iterative.krylov`
accept any `(matvec, preconditioner)` pair of tensor -> tensor callables;
this module produces them:

    as_matvec(A, mesh)    CSR -> scatter-add SpMV closure (`index_add_`;
                          under a mesh, each rank's share of the
                          nonzeros and one all_reduce); callables pass
                          through.
    as_preconditioner(M)  None -> identity; Preconditioner -> its device
                          application (device_apply); TriangularOperator
                          -> its device_solve_fn; objects with only a host
                          .solve -> a host round trip (solve_callback);
                          callables pass through.

Everything returned takes single `(n,)` and batched `(n, k)` tensors.
The matvec stays plain PyTorch, as the reference's stays a scatter-add
outside any Pallas kernel: the ELL kernel (K4) would pad every row to the
widest one, which for lung2's 2,143-entry row is 0.2% fill (PERF.md).
Under a mesh the Krylov solvers run as SPMD programs: every rank holds
the same replicated vectors, so their convergence tests agree.
"""
from __future__ import annotations

import numpy as np
import torch

from ..sparse.csr import CSR

__all__ = ["device_matvec", "as_matvec", "as_preconditioner",
           "solve_callback"]


def device_matvec(A: CSR, mesh=None, axis: str = "model"):
    """y = A @ x as a tensor closure (scatter-add SpMV).

    The CSR arrays are staged at first use on x's device: the row and
    column indices once per device, the values once per device and dtype,
    so the same closure serves float32 and float64 operands on any device,
    single (n,) or batched (n, k).

    With `mesh` (a DeviceMesh and its `axis`), the nonzeros are sharded
    over the axis: the nnz triplet is padded to a multiple of the axis
    size with inert entries (row n, value 0), each rank scatter-adds its
    block's products into an (n+1, ...) accumulator, and one all_reduce
    sums them — ONE collective per matvec.  x is replicated (every rank
    passes the same x, on the mesh's device), and so is y.
    """
    rows_np = np.repeat(np.arange(A.n_rows), A.row_nnz())
    cols_np = np.asarray(A.indices)
    data_np = np.asarray(A.data)
    n_rows = A.n_rows
    if mesh is not None:
        return _sharded_matvec(rows_np, cols_np, data_np, n_rows, mesh, axis)
    staged: dict = {}

    def matvec(x: torch.Tensor) -> torch.Tensor:
        key = (x.device, x.dtype)
        entry = staged.get(key)
        if entry is None:
            idx = staged.get(x.device)
            if idx is None:
                idx = staged[x.device] = (
                    torch.as_tensor(rows_np, dtype=torch.long,
                                    device=x.device),
                    torch.as_tensor(cols_np, dtype=torch.long,
                                    device=x.device))
            entry = staged[key] = idx + (
                torch.as_tensor(data_np, dtype=x.dtype, device=x.device),)
        rows, cols, data = entry
        gathered = x[cols]
        prod = data * gathered if x.ndim == 1 else data[:, None] * gathered
        out = torch.zeros((n_rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        return out.index_add_(0, rows, prod)

    return matvec


def _sharded_matvec(rows_np, cols_np, data_np, n_rows: int, mesh,
                    axis: str):
    """device_matvec's mesh path (its doc)."""
    import torch.distributed as dist
    from ..solver.distributed import axis_group, mesh_device
    group, nshards, rank = axis_group(mesh, axis)
    device = mesh_device(mesh)
    nnz_pad = -(-max(rows_np.size, 1) // nshards) * nshards
    pad = nnz_pad - rows_np.size
    block = slice(rank * (nnz_pad // nshards),
                  (rank + 1) * (nnz_pad // nshards))
    # row n_rows is a garbage accumulator slot dropped at the end
    rows = torch.as_tensor(np.concatenate(
        [rows_np, np.full(pad, n_rows, rows_np.dtype)])[block],
        dtype=torch.long, device=device)
    cols = torch.as_tensor(np.concatenate(
        [cols_np, np.zeros(pad, cols_np.dtype)])[block],
        dtype=torch.long, device=device)
    data_sh = np.concatenate([data_np, np.zeros(pad, data_np.dtype)])[block]
    data_by_dtype: dict = {}

    def matvec(x: torch.Tensor) -> torch.Tensor:
        if x.device.type != device.type:
            raise ValueError(f"the sharded matvec lies on {device}, the "
                             f"vector on {x.device}")
        data = data_by_dtype.get(x.dtype)
        if data is None:
            data = data_by_dtype[x.dtype] = torch.as_tensor(
                data_sh, dtype=x.dtype, device=device)
        gathered = x[cols]
        prod = data * gathered if x.ndim == 1 else data[:, None] * gathered
        out = torch.zeros((n_rows + 1,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=device)
        out.index_add_(0, rows, prod)
        dist.all_reduce(out, group=group)
        return out[:n_rows]

    return matvec


def as_matvec(spec, mesh=None, axis: str = "model"):
    """CSR -> device_matvec(spec, mesh, axis); callables pass through."""
    if isinstance(spec, CSR):
        return device_matvec(spec, mesh=mesh, axis=axis)
    if callable(spec):
        return spec
    raise TypeError(f"matvec must be a CSR matrix or a callable, got "
                    f"{type(spec).__name__}")


def solve_callback(solve_fn):
    """Lift a host solve (e.g. TriangularOperator.solve) into a tensor
    callable: tensor -> numpy float64 -> solve_fn -> tensor of the input's
    dtype and device."""

    def apply(r: torch.Tensor) -> torch.Tensor:
        rr = r.detach().cpu().numpy().astype(np.float64)
        out = np.asarray(solve_fn(rr))
        return torch.as_tensor(out, dtype=r.dtype, device=r.device)

    return apply


def as_preconditioner(spec):
    """Resolve a preconditioner spec to a tensor callable (module doc).

    Order matters: the device paths (`.device_apply` on a Preconditioner,
    `.device_solve_fn` on a TriangularOperator) beat plain callability, so
    those objects run on the device with no host round trip in the Krylov
    loop; a host-only `.solve` goes through `solve_callback`.
    """
    if spec is None:
        return lambda r: r
    if hasattr(spec, "device_apply"):
        return spec.device_apply()
    if hasattr(spec, "device_solve_fn"):
        return spec.device_solve_fn()
    if isinstance(spec, CSR):
        raise TypeError(
            "a raw CSR matrix is ambiguous as a preconditioner (M or "
            "M^-1?); pass precond.Preconditioner.ic0/ilu0(A) or an "
            "explicit callable applying M^-1")
    if callable(spec):
        return spec
    if hasattr(spec, "solve"):
        return solve_callback(spec.solve)
    raise TypeError(f"cannot interpret {type(spec).__name__} as a "
                    f"preconditioner: expected None, a callable, a "
                    f"Preconditioner, or an object with .solve")
