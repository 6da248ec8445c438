"""Krylov solvers on torch tensors: cg, bicgstab, restarted gmres.

Port of `repro.iterative.krylov`.  The consumer side of the
preconditioning subsystem, whose inner kernel is the transformed SpTRSV
(via `precond.Preconditioner`):

    A = generators.poisson2d_spd(64, 64)
    P = Preconditioner.ic0(A)
    res = cg(A, b, preconditioner=P, tol=1e-8)
    res.x, res.iterations, res.residual_norms

Solver contract
===============
* `matvec` is a CSR matrix (a scatter-add SpMV, `operators.device_matvec`)
  or any tensor callable; `preconditioner` is None, a `Preconditioner`, a
  `TriangularOperator`, or a callable applying M^-1 (see
  `iterative.operators` for the adapter rules).
* Right-hand sides are single `(n,)` or batched `(n, k)`; batched columns
  converge independently (per-column masking), so one schedule streams
  all k columns.
* Devices: a torch `b` keeps its device; a numpy `b` goes to `device`
  (None = the CUDA card, raising without one, or the mesh's device under
  `mesh=`).
* `mesh=` (a DeviceMesh, with `mesh_axis=`) turns a CSR `matvec` into the
  sharded SpMV (one all_reduce per matvec); with a preconditioner built
  under the same mesh the whole solve runs under one mesh.  Every rank
  calls the solver with the same b and gets the same x: the loop's
  decisions come from replicated tensors.  A preconditioner (or x0)
  on another device than b raises.  The iteration runs in b's dtype: a
  float64 b gives float64 iterations around the float32 sweeps of M^-1.
* Each `lax.while_loop` of the reference is a Python loop with the same
  state, the same per-column masking and the same candidate commit.  The
  loop stops when every column is done or broken, which costs one host
  sync per iteration (gmres: per inner step).
* Convergence: ||r||_2 <= max(tol * ||b||_2, atol) per column, residuals
  in the working dtype.  `gmres` iterates on the left-preconditioned
  system, so its tolerance and recorded history are PRECONDITIONED
  residual norms (cg/bicgstab record true residuals).

`SolveResult.residual_norms` carries the per-iteration history in a
`(maxiter+1,) + batch` tensor (NaN beyond each column's last iteration);
`iterations` counts the iterations each column actually ran.
`SolveResult.status` classifies each column's outcome — STATUS_CONVERGED,
STATUS_MAXITER, or STATUS_BREAKDOWN (`status_labels` decodes): a column
whose step turns non-finite (an unstable preconditioner, a singular
operator, a bad right-hand side) is frozen at its last healthy iterate
and reported as a breakdown.  When the preconditioner has `stats()`,
`SolveResult.stats` carries them.  With tracing on (`repro_torch.obs`),
each solver emits the reference's `krylov.residual` events from the
history after its loop (at most 64, evenly spaced).
"""
from __future__ import annotations

import math
import typing

import numpy as np
import torch

from ..obs import trace as _obs
from .operators import as_matvec, as_preconditioner

__all__ = ["SolveResult", "cg", "bicgstab", "gmres",
           "STATUS_MAXITER", "STATUS_CONVERGED", "STATUS_BREAKDOWN",
           "STATUS_LABELS", "status_labels"]

# per-column outcome codes carried in SolveResult.status (int32)
STATUS_MAXITER = 0      # ran out of iterations without converging
STATUS_CONVERGED = 1    # hit the residual target
STATUS_BREAKDOWN = 2    # frozen at the last healthy iterate (non-finite
#                         step, or a bicgstab rho/omega collapse)
STATUS_LABELS = ("maxiter", "converged", "breakdown")

_NAN = float("nan")


def status_labels(status):
    """Host-side decoder: a SolveResult.status tensor -> label strings."""
    if isinstance(status, torch.Tensor):
        status = status.cpu().numpy()
    return np.asarray(STATUS_LABELS, dtype=object)[np.asarray(status)]


class SolveResult(typing.NamedTuple):
    """Outcome of a Krylov solve; every field but `stats` is a tensor on
    b's device.

    x:              solution, same shape as b.
    converged:      bool per column (batch shape).
    iterations:     int32 per column — iterations actually run.
    residual_norms: (maxiter+1,) + batch, residual 2-norms per iteration
                    (index 0 = initial residual), NaN-padded past each
                    column's final iteration.
    status:         int32 per column — STATUS_CONVERGED, STATUS_MAXITER,
                    or STATUS_BREAKDOWN (`status_labels` decodes).
                    Breakdown columns are frozen at their last healthy
                    iterate: `x` is finite and usable, just not converged.
    stats:          the preconditioner's `stats()` dict when it has one,
                    else None.  Its operator counters tick on host
                    `apply()` calls only, not on the device applications
                    inside the loop.
    """

    x: typing.Any
    converged: typing.Any
    iterations: typing.Any
    residual_norms: typing.Any
    status: typing.Any = None
    stats: typing.Any = None

    def final_residual(self) -> torch.Tensor:
        """Last recorded residual norm per column."""
        idx = torch.as_tensor(self.iterations).long()
        return torch.take_along_dim(self.residual_norms, idx[None, ...],
                                    dim=0)[0]


def _vdot(u, v):
    return (u * v).sum(dim=0)


def _norm(v):
    return torch.sqrt(_vdot(v, v))


def _guard(d):
    """Replace zero denominators by 1 (the quotient is masked anyway)."""
    return torch.where(d == 0, torch.ones_like(d), d)


def _same_device(t: torch.Tensor, device) -> bool:
    return torch.device(device).type == t.device.type


def _prepare(matvec, preconditioner, b, x0, tol, atol, device, mesh=None,
             mesh_axis: str = "model"):
    """Shared setup: resolve operators and the device, initial x/r and the
    convergence target."""
    from ..solver.levelset import resolve_device
    A = as_matvec(matvec, mesh=mesh, axis=mesh_axis)
    M = as_preconditioner(preconditioner)
    if mesh is not None and device is None:
        from ..solver.distributed import mesh_device
        device = mesh_device(mesh)
    if isinstance(b, torch.Tensor):
        if device is not None and not _same_device(b, device):
            raise ValueError(f"b lies on {b.device}, not on {device}")
    else:
        b = torch.as_tensor(np.asarray(b), device=resolve_device(device))
    if b.ndim not in (1, 2):
        raise ValueError(f"b must be (n,) or (n, k), got shape "
                         f"{tuple(b.shape)}")
    pdev = getattr(preconditioner, "device", None)
    if pdev is not None and not _same_device(b, pdev):
        raise ValueError(f"the preconditioner lies on {pdev}, b on "
                         f"{b.device}")
    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        if isinstance(x0, torch.Tensor) and not _same_device(b, x0.device):
            raise ValueError(f"x0 lies on {x0.device}, b on {b.device}")
        x = torch.as_tensor(x0, dtype=b.dtype, device=b.device)
        if x.shape != b.shape:
            raise ValueError(f"x0 must have b's shape {tuple(b.shape)}, got "
                             f"{tuple(x.shape)}")
        r = b - A(x)
    target = torch.clamp_min(tol * _norm(b), atol).to(b.dtype)
    return A, M, b, x, r, target


def _status(done, brk):
    return torch.where(done, STATUS_CONVERGED,
                       torch.where(brk, STATUS_BREAKDOWN, STATUS_MAXITER)
                       ).to(torch.int32)


# per-solver residual events are capped: a 10k-iteration solve must not
# flood the trace, so the history is thinned to evenly spaced samples
_TRACE_EVENT_CAP = 64


def _trace_iterations(hist: torch.Tensor, iters: torch.Tensor,
                      solver: str) -> None:
    """`krylov.residual` events from the recorded history (first column
    when batched), read after the loop and only while tracing is on, so a
    disabled tracer costs no device-to-host copy."""
    if not _obs.enabled():
        return
    col = hist.double().cpu().numpy()
    col = col if col.ndim == 1 else col[:, 0]
    last = int(iters.max())
    idx = np.arange(min(last + 1, col.shape[0]))
    if idx.size > _TRACE_EVENT_CAP:
        idx = np.unique(np.linspace(0, idx[-1],
                                    _TRACE_EVENT_CAP).astype(int))
    for i in idx:
        if np.isfinite(col[i]):
            _obs.event("krylov.residual", driver=solver, iteration=int(i),
                       residual=float(col[i]))


def _finish(x, done, brk, iters, hist, preconditioner,
            solver: str) -> SolveResult:
    """Build the result, emit its residual events and merge the
    preconditioner's stats into it."""
    _trace_iterations(hist, iters, solver)
    stats_fn = getattr(preconditioner, "stats", None)
    return SolveResult(x=x, converged=done, iterations=iters,
                       residual_norms=hist, status=_status(done, brk),
                       stats=stats_fn() if callable(stats_fn) else None)


def _running(it: int, maxiter: int, done, brk) -> bool:
    """Loop condition: iterations left and a column still active (one
    host sync)."""
    return it < maxiter and not bool((done | brk).all())


def cg(matvec, b, *, preconditioner=None, x0=None, tol: float = 1e-8,
       atol: float = 0.0, maxiter: int | None = None,
       device=None, mesh=None,
       mesh_axis: str = "model") -> SolveResult:
    """Preconditioned conjugate gradient for SPD systems.

    matvec/preconditioner: see module doc (M^-1 must be SPD — ic0 is).
    maxiter: history length and iteration cap; defaults to n.
    """
    A, M, b, x, r, target = _prepare(matvec, preconditioner, b, x0, tol,
                                     atol, device, mesh, mesh_axis)
    n = b.shape[0]
    maxiter = n if maxiter is None else int(maxiter)
    batch = tuple(b.shape[1:])
    hist = torch.full((maxiter + 1,) + batch, _NAN, dtype=b.dtype,
                      device=b.device)
    rn0 = _norm(r)
    hist[0] = rn0
    z = M(r)
    p = z
    rz = _vdot(r, z)
    done = rn0 <= target
    brk = torch.zeros(batch, dtype=torch.bool, device=b.device)
    iters = torch.zeros(batch, dtype=torch.int32, device=b.device)
    it = 0
    while _running(it, maxiter, done, brk):
        stop = done | brk
        Ap = A(p)
        alpha = torch.where(stop, 0.0, rz / _guard(_vdot(p, Ap)))
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        rn = _norm(r_new)
        z = M(r_new)
        rz_new = _vdot(r_new, z)
        # a non-finite residual or curvature means this step poisoned the
        # column (singular A, unstable M, overflow): freeze it at the last
        # healthy iterate and report breakdown, never return garbage
        bad = ~stop & ~(torch.isfinite(rn) & torch.isfinite(rz_new))
        ok = ~stop & ~bad
        x = torch.where(ok, x_new, x)
        r = torch.where(ok, r_new, r)
        hist[it + 1] = torch.where(ok, rn, _NAN)
        iters = iters + ok.to(torch.int32)
        beta = rz_new / _guard(rz)
        p = torch.where(ok, z + beta * p, p)
        rz = torch.where(ok, rz_new, rz)
        done = done | (ok & (rn <= target))
        brk = brk | bad
        it += 1
    return _finish(x, done, brk, iters, hist, preconditioner, "cg")


def bicgstab(matvec, b, *, preconditioner=None, x0=None, tol: float = 1e-8,
             atol: float = 0.0, maxiter: int | None = None,
             device=None, mesh=None,
             mesh_axis: str = "model") -> SolveResult:
    """Preconditioned BiCGStab for general (nonsymmetric) systems.

    Right-preconditioned van der Vorst form: two matvecs and two M^-1
    applications per iteration; the recorded history is the TRUE residual
    norm.  Breakdown (rho or omega collapsing) freezes the affected
    column with converged=False.
    """
    A, M, b, x, r, target = _prepare(matvec, preconditioner, b, x0, tol,
                                     atol, device, mesh, mesh_axis)
    n = b.shape[0]
    maxiter = n if maxiter is None else int(maxiter)
    batch = tuple(b.shape[1:])
    dt, dev = b.dtype, b.device
    hist = torch.full((maxiter + 1,) + batch, _NAN, dtype=dt, device=dev)
    rn0 = _norm(r)
    hist[0] = rn0
    rhat = r
    rho = torch.ones(batch, dtype=dt, device=dev)
    alpha = torch.ones(batch, dtype=dt, device=dev)
    omega = torch.ones(batch, dtype=dt, device=dev)
    v = torch.zeros_like(b)
    p = torch.zeros_like(b)
    done = rn0 <= target
    brk = torch.zeros(batch, dtype=torch.bool, device=dev)
    iters = torch.zeros(batch, dtype=torch.int32, device=dev)
    eps = torch.finfo(dt).tiny * 1e3
    it = 0
    while _running(it, maxiter, done, brk):
        stop = done | brk
        rho_new = _vdot(rhat, r)
        broke = torch.abs(rho_new) < eps
        beta = (rho_new / _guard(rho)) * (alpha / _guard(omega))
        p = torch.where(stop, p, r + beta * (p - omega * v))
        phat = M(p)
        v_new = A(phat)
        denom = _vdot(rhat, v_new)
        broke = broke | (torch.abs(denom) < eps)
        alpha_new = torch.where(stop | broke, 0.0, rho_new / _guard(denom))
        s = r - alpha_new * v_new
        shat = M(s)
        t = A(shat)
        tt = _vdot(t, t)
        omega_new = torch.where(stop | broke, 0.0, _vdot(t, s) / _guard(tt))
        x_cand = x + alpha_new * phat + omega_new * shat
        r_cand = s - omega_new * t
        rn = _norm(r_cand)
        # a non-finite candidate (unstable M, singular A, overflow) is a
        # breakdown like rho/omega collapse: freeze the column at its last
        # healthy iterate, never commit a poisoned x
        broke = broke | ~torch.isfinite(rn)
        upd = ~(stop | broke)
        x = torch.where(upd, x_cand, x)
        r = torch.where(upd, r_cand, r)
        # a breakdown step is NOT a productive iteration: x/r are frozen,
        # so record nothing and leave the count at the last real step
        hist[it + 1] = torch.where(upd, rn, _NAN)
        iters = iters + upd.to(torch.int32)
        v = torch.where(upd, v_new, v)
        rho = torch.where(upd, rho_new, rho)
        alpha = torch.where(upd, alpha_new, alpha)
        omega = torch.where(upd, omega_new, omega)
        done = done | (upd & (rn <= target))
        brk = brk | (~stop & broke)
        it += 1
    return _finish(x, done, brk, iters, hist, preconditioner,
                   "bicgstab")


def gmres(matvec, b, *, preconditioner=None, x0=None, tol: float = 1e-8,
          atol: float = 0.0, restart: int = 30, maxiter: int | None = None,
          device=None, mesh=None,
          mesh_axis: str = "model") -> SolveResult:
    """Restarted GMRES(m) for general systems, left-preconditioned.

    Arnoldi with twice-iterated classical Gram-Schmidt (CGS2, vectorized
    over batched columns) and Givens-rotation least squares; `restart` is
    the Krylov dimension m, `maxiter` the number of restart cycles
    (default: enough cycles to cover n total iterations).

    Iterates on M^-1 A x = M^-1 b: tolerance and recorded history are
    PRECONDITIONED residual norms (|g_{j+1}| estimates inside a cycle, the
    recomputed true value of M^-1(b - Ax) at cycle boundaries).  History
    entries are written at per-column positions, so `iterations` counts
    each column's productive inner iterations and `hist[iterations]` is
    its last recorded estimate even when a column pauses mid-cycle.
    """
    # _prepare's target tracks the UNpreconditioned rhs; gmres replaces it
    # below with the preconditioned one (left-preconditioned iteration)
    A, M, b, x, _r0, _ = _prepare(matvec, preconditioner, b, x0, tol, atol,
                                  device, mesh, mesh_axis)
    n = b.shape[0]
    m = max(1, min(int(restart), n))
    maxiter = max(1, math.ceil(n / m)) if maxiter is None else int(maxiter)
    batch = tuple(b.shape[1:])
    dt, dev = b.dtype, b.device
    lift = (-1,) + (1,) * len(batch)        # lift (m+1,) over batch
    mb = M(b)
    target = torch.clamp_min(tol * _norm(mb), atol).to(dt)
    hist = torch.full((maxiter * m + 1,) + batch, _NAN, dtype=dt, device=dev)
    r = M(b - A(x)) if x0 is not None else mb
    rn = _norm(r)
    hist[0] = rn
    done = rn <= target
    brk = torch.zeros(batch, dtype=torch.bool, device=dev)
    iters = torch.zeros(batch, dtype=torch.int32, device=dev)
    basis_idx = torch.arange(m + 1, device=dev)

    # per-COLUMN history positions (iters + 1), not the absolute cycle
    # index: a column whose |g| estimate converges mid-cycle but whose
    # cycle-end recompute disagrees resumes writing right after its last
    # entry, so `iterations` stays the productive count and
    # hist[iterations] is always the last recorded estimate, gap-free
    if batch:
        col_idx = torch.arange(batch[0], device=dev)

        def hist_write(pos, val):
            hist[pos.long(), col_idx] = val
    else:
        def hist_write(pos, val):
            hist[pos.long()] = val

    cycle = 0
    while _running(cycle, maxiter, done, brk):
        iters_in = iters        # rollback point for a poisoned cycle
        V = torch.zeros((m + 1, n) + batch, dtype=dt, device=dev)
        V[0] = r / _guard(rn)
        H = torch.zeros((m + 1, m) + batch, dtype=dt, device=dev)
        cs = torch.zeros((m + 1,) + batch, dtype=dt, device=dev)
        sn = torch.zeros((m + 1,) + batch, dtype=dt, device=dev)
        g = torch.zeros((m + 1,) + batch, dtype=dt, device=dev)
        g[0] = rn
        inner_done = done | brk
        for j in range(m):
            # once every column is done the remaining steps change nothing
            # (each is masked by inner_done), so they are skipped
            if bool(inner_done.all()):
                break
            w = M(A(V[j]))
            # CGS2: two passes of classical Gram-Schmidt against V[0..j],
            # vectorized over the basis axis with an i<=j mask
            mask = (basis_idx <= j).view(lift)
            h1 = torch.where(mask, (V * w[None]).sum(dim=1), 0.0)
            w = w - (h1[:, None] * V).sum(dim=0)
            h2 = torch.where(mask, (V * w[None]).sum(dim=1), 0.0)
            w = w - (h2[:, None] * V).sum(dim=0)
            hcol = h1 + h2
            hnext = _norm(w)
            V[j + 1] = torch.where(inner_done, V[j + 1], w / _guard(hnext))
            # apply the stored Givens rotations 0..j-1 to the new column
            for i in range(j):
                hi, hi1 = hcol[i], hcol[i + 1]
                new_hi = cs[i] * hi + sn[i] * hi1
                new_hi1 = -sn[i] * hi + cs[i] * hi1
                hcol[i] = new_hi
                hcol[i + 1] = new_hi1
            # new rotation zeroing the subdiagonal h_{j+1,j}
            hj = hcol[j]
            d = torch.sqrt(hj ** 2 + hnext ** 2)
            cs_j = torch.where(d == 0, 1.0, hj / _guard(d))
            sn_j = torch.where(d == 0, 0.0, hnext / _guard(d))
            hcol[j] = d
            hcol[j + 1] = 0.0
            H[:, j] = torch.where(inner_done, H[:, j], hcol)
            cs[j] = torch.where(inner_done, cs[j], cs_j)
            sn[j] = torch.where(inner_done, sn[j], sn_j)
            g_j = g[j].clone()
            g_next = -sn_j * g_j
            g[j] = torch.where(inner_done, g_j, cs_j * g_j)
            g[j + 1] = torch.where(inner_done, g[j + 1], g_next)
            res_est = torch.abs(g[j + 1])
            hist_write(torch.clamp_max(iters + 1, maxiter * m),
                       torch.where(inner_done, _NAN, res_est))
            iters = iters + (~inner_done).to(torch.int32)
            inner_done = inner_done | (res_est <= target) | (hnext == 0)
        # back-substitute H y = g on the m x m triangle; columns the cycle
        # never reached have H[i,i] == 0 and g[i] == 0 -> y_i = 0
        y = torch.zeros((m,) + batch, dtype=dt, device=dev)
        for i in range(m - 1, -1, -1):
            s = (H[i] * y).sum(dim=0)       # y[l] == 0 for l <= i still
            yi = (g[i] - s) / _guard(H[i, i])
            y[i] = torch.where(torch.abs(H[i, i]) > 0, yi, 0.0)
        x_new = x + (y[:, None] * V[:m]).sum(dim=0)
        r_new = M(b - A(x_new))
        rn_new = _norm(r_new)
        # a non-finite recomputed residual means the cycle poisoned the
        # column (unstable M, singular A, NaN rhs): roll x and the
        # iteration count back to the cycle start and report breakdown
        active = ~(done | brk)
        bad = active & ~torch.isfinite(rn_new)
        ok = active & ~bad
        x = torch.where(ok, x_new, x)
        r = torch.where(ok, r_new, r)
        rn = torch.where(ok, rn_new, rn)
        iters = torch.where(bad, iters_in, iters)
        done = done | (ok & (rn_new <= target))
        brk = brk | bad
        cycle += 1
    return _finish(x, done, brk, iters, hist, preconditioner,
                   "gmres")
