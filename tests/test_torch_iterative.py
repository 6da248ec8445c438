"""The port's Krylov solvers and matvec against the reference's.

Tolerances:
* `device_matvec`: float32 1e-6 and float64 1e-12 relative (the two
  scatter-adds may sum a row's products in another order).
* Unpreconditioned float64 solves run the same arithmetic in both
  packages: equal iteration counts, and x and the residual histories
  within 1e-9 relative to scale (max(1, largest entry): a late residual
  of 1e-8 carries float64 noise of the initial one's size, ~1e-16 x 50),
  with NaN in the same places.
* Preconditioned solves apply M^-1 in float32 sweeps that sum each row in
  their own order, so the iterates drift apart by rounding: iterations
  within +-1, both converged, x within 1e-6.
The reference runs under `jax.enable_x64(True)`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.iterative import bicgstab as ref_bicgstab
from repro.iterative import cg as ref_cg
from repro.iterative import device_matvec as ref_device_matvec
from repro.iterative import gmres as ref_gmres
from repro.precond import Preconditioner as RefPreconditioner
from repro.solver import TriangularOperator as RefOperator
from repro.sparse import generators as ref_gen
from repro.sparse.csr import CSR as RefCSR

from repro_torch.iterative import (SolveResult, as_matvec,
                                   as_preconditioner, bicgstab, cg,
                                   device_matvec, gmres, solve_callback)
from repro_torch.iterative.krylov import (STATUS_BREAKDOWN,
                                          STATUS_CONVERGED, STATUS_MAXITER,
                                          status_labels)
from repro_torch.precond import Preconditioner
from repro_torch.solver import TriangularOperator
from repro_torch.sparse import generators
from repro_torch.sparse.csr import CSR

torch.set_num_threads(1)

EXACT_TOL = 1e-9
PRECOND_X_TOL = 1e-6


def nonsymmetric(gen, csr, n=120, seed=7):
    """tests/test_iterative.py's recipe: random SPD values + 0.25 U(-1,1)."""
    rng = np.random.default_rng(seed)
    A = gen.random_spd(n, avg_offdiag=2.5, seed=seed)
    return csr(indptr=A.indptr, indices=A.indices,
               data=A.data + 0.25 * rng.uniform(-1, 1, A.nnz),
               shape=A.shape)


def _spd():
    return generators.poisson2d_spd(16, 16), ref_gen.poisson2d_spd(16, 16)


def _nonsym():
    return nonsymmetric(generators, CSR), nonsymmetric(ref_gen, RefCSR)


@pytest.fixture(autouse=True)
def _fresh_memory_cache(tmp_path, monkeypatch):
    # the operator's disk tier writes under the test's own directory
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "cache"))
    TriangularOperator.clear_memory_cache()
    RefOperator.clear_memory_cache()
    yield
    TriangularOperator.clear_memory_cache()
    RefOperator.clear_memory_cache()


def _ref_np(res):
    return {k: np.asarray(getattr(res, k)) for k in
            ("x", "converged", "iterations", "residual_norms", "status")}


def _np(res):
    return {k: getattr(res, k).cpu().numpy() for k in
            ("x", "converged", "iterations", "residual_norms", "status")}


def _close(a, b, tol):
    return np.abs(a - b).max() <= tol * max(1.0, np.abs(b).max())


# -- (c) matvec ---------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6),
                                       (np.float64, 1e-12)])
@pytest.mark.parametrize("shape", [(), (4,)])
def test_device_matvec_matches_reference(shape, dtype, tol):
    A, A_ref = _nonsym()
    x = np.random.default_rng(0).standard_normal((A.n_rows,) + shape) \
        .astype(dtype)
    y = device_matvec(A)(torch.as_tensor(x))
    with jax.enable_x64(True):
        y_ref = np.asarray(ref_device_matvec(A_ref)(jnp.asarray(x)))
    assert y.dtype == torch.from_numpy(x).dtype and y_ref.dtype == dtype
    assert y.shape == x.shape
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=tol, atol=tol)


def test_device_matvec_serves_both_dtypes_and_rejects_mesh():
    A, _ = _nonsym()
    mv = as_matvec(A)
    x = np.random.default_rng(1).standard_normal(A.n_rows)
    y64 = mv(torch.as_tensor(x))
    y32 = mv(torch.as_tensor(x, dtype=torch.float32))
    np.testing.assert_allclose(y64.numpy(), A.matvec(x), rtol=1e-12)
    np.testing.assert_allclose(y32.numpy(), A.matvec(x), rtol=1e-5,
                               atol=1e-5)
    # mesh= is ported (tests/test_torch_distributed.py); what is no
    # DeviceMesh is refused before anything is staged
    with pytest.raises(TypeError, match="DeviceMesh"):
        device_matvec(A, mesh=object())
    with pytest.raises(TypeError, match="CSR matrix or a callable"):
        as_matvec(np.eye(3))


# -- (e) Krylov parity --------------------------------------------------------

def _run_pair(solver, ref_solver, A, A_ref, b, **kw):
    res = solver(A, torch.as_tensor(b), **kw)
    with jax.enable_x64(True):
        ref = ref_solver(A_ref, jnp.asarray(b), **kw)
        ref = _ref_np(ref)
    return _np(res), ref


PLAIN_CASES = [("cg", {}), ("bicgstab", {}), ("gmres", {}),
               ("gmres", {"restart": 5})]
SOLVERS = {"cg": (cg, ref_cg), "bicgstab": (bicgstab, ref_bicgstab),
           "gmres": (gmres, ref_gmres)}


@pytest.mark.parametrize("name,kw", PLAIN_CASES,
                         ids=["cg", "bicgstab", "gmres", "gmres-restart5"])
def test_unpreconditioned_float64_matches_reference(name, kw):
    A, A_ref = _spd() if name == "cg" else _nonsym()
    b = A.matvec(np.random.default_rng(3).standard_normal(A.n_rows))
    solver, ref_solver = SOLVERS[name]
    got, ref = _run_pair(solver, ref_solver, A, A_ref, b, tol=1e-10, **kw)
    assert got["x"].dtype == np.float64
    assert bool(got["converged"]) and bool(ref["converged"])
    assert int(got["iterations"]) == int(ref["iterations"])
    assert int(got["status"]) == int(ref["status"]) == STATUS_CONVERGED
    assert _close(got["x"], ref["x"], EXACT_TOL)
    h, h_ref = got["residual_norms"], ref["residual_norms"]
    assert h.shape == h_ref.shape
    np.testing.assert_array_equal(np.isnan(h), np.isnan(h_ref))
    assert _close(h[~np.isnan(h)], h_ref[~np.isnan(h_ref)], EXACT_TOL)


@pytest.mark.parametrize("strategy", ["no_rewriting", "avgLevelCost"])
@pytest.mark.parametrize("name", ["cg", "bicgstab", "gmres"])
def test_preconditioned_matches_reference(name, strategy, tmp_path):
    """The slice as a whole: the port's own ic0/ilu0 and operators against
    the reference's, inside each solver."""
    A, A_ref = _spd() if name == "cg" else _nonsym()
    kind = "ic0" if name == "cg" else "ilu0"
    P = getattr(Preconditioner, kind)(A, tune=strategy, device="cpu")
    P_ref = getattr(RefPreconditioner, kind)(A_ref, tune=strategy,
                                             cache_dir=tmp_path)
    x_true = np.random.default_rng(4).standard_normal(A.n_rows)
    b = A.matvec(x_true)
    solver, ref_solver = SOLVERS[name]
    base = int(solver(A, torch.as_tensor(b), tol=1e-8).iterations)
    got = _np(solver(A, torch.as_tensor(b), preconditioner=P, tol=1e-8))
    with jax.enable_x64(True):
        ref = _ref_np(ref_solver(A_ref, jnp.asarray(b), preconditioner=P_ref,
                                 tol=1e-8))
    assert bool(got["converged"]) and bool(ref["converged"])
    assert abs(int(got["iterations"]) - int(ref["iterations"])) <= 1
    assert int(got["iterations"]) < base
    assert _close(got["x"], ref["x"], PRECOND_X_TOL)
    assert _close(got["x"], x_true, 1e-5)


# -- (f) solver contracts -----------------------------------------------------

@pytest.mark.parametrize("name", ["cg", "bicgstab", "gmres"])
def test_batched_columns_equal_single_column_runs(name):
    A = _spd()[0] if name == "cg" else _nonsym()[0]
    kind = "ic0" if name == "cg" else "ilu0"
    P = getattr(Preconditioner, kind)(A, tune="no_rewriting", device="cpu")
    solver = SOLVERS[name][0]
    B = np.random.default_rng(6).standard_normal((A.n_rows, 3))
    res = solver(A, torch.as_tensor(B), preconditioner=P, tol=1e-8)
    assert isinstance(res, SolveResult)
    assert res.x.shape == B.shape and res.iterations.shape == (3,)
    assert res.residual_norms.shape[1:] == (3,)
    assert res.stats["kind"] == kind
    for j in range(3):
        one = solver(A, torch.as_tensor(B[:, j]), preconditioner=P,
                     tol=1e-8)
        assert int(one.iterations) == int(res.iterations[j])
        assert bool(one.converged) and bool(res.converged[j])
        assert _close(res.x[:, j].numpy(), one.x.numpy(), 1e-5)
        last = int(res.iterations[j])
        assert float(res.final_residual()[j]) == \
            float(res.residual_norms[last, j])


@pytest.mark.parametrize("name", ["cg", "bicgstab", "gmres"])
def test_maxiter_cap_reports_maxiter(name):
    A = _spd()[0] if name == "cg" else _nonsym()[0]
    b = np.random.default_rng(7).standard_normal(A.n_rows)
    kw = {"restart": 2} if name == "gmres" else {}      # 2 cycles of 2
    res = SOLVERS[name][0](A, b, tol=1e-14, maxiter=2, device="cpu", **kw)
    assert int(res.status) == STATUS_MAXITER and not bool(res.converged)
    assert status_labels(res.status) == "maxiter"
    hist = res.residual_norms.numpy()
    last = int(res.iterations)
    assert np.isfinite(hist[:last + 1]).all()
    assert np.isnan(hist[last + 1:]).all()


@pytest.mark.parametrize("name", ["cg", "bicgstab", "gmres"])
def test_nan_preconditioner_reports_breakdown(name):
    A = _spd()[0] if name == "cg" else _nonsym()[0]
    b = torch.as_tensor(np.random.default_rng(8).standard_normal(
        (A.n_rows, 2)))
    poisoned = lambda r: torch.full_like(r, float("nan"))    # noqa: E731
    res = SOLVERS[name][0](A, b, preconditioner=poisoned, tol=1e-8)
    assert (res.status == STATUS_BREAKDOWN).all()
    assert not res.converged.any()
    assert torch.isfinite(res.x).all()
    assert list(status_labels(res.status)) == ["breakdown", "breakdown"]


def test_bad_shapes_and_devices_raise():
    A, _ = _spd()
    n = A.n_rows
    with pytest.raises(ValueError, match=r"\(n,\) or \(n, k\)"):
        cg(A, torch.zeros((n, 2, 2), dtype=torch.float64))
    with pytest.raises(ValueError, match="x0 must have"):
        cg(A, torch.zeros(n, dtype=torch.float64),
           x0=torch.zeros(n + 1, dtype=torch.float64))
    with pytest.raises(ValueError, match="not on"):
        cg(A, torch.zeros(n, dtype=torch.float64), device="meta")
    P = Preconditioner.ic0(A, tune="no_rewriting", device="cpu")
    with pytest.raises(ValueError, match="preconditioner lies on"):
        cg(A, torch.zeros(n, dtype=torch.float64, device="meta"),
           preconditioner=P)
    with pytest.raises(TypeError, match="ambiguous"):
        cg(A, torch.zeros(n, dtype=torch.float64), preconditioner=A)


def test_numpy_rhs_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A, _ = _spd()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cg(A, np.ones(A.n_rows))
    res = cg(A, np.ones(A.n_rows), device="cpu")
    assert res.x.device.type == "cpu" and res.x.dtype == torch.float64


def test_as_preconditioner_resolution_order():
    A, _ = _spd()
    P = Preconditioner.ic0(A, tune="no_rewriting", device="cpu")
    assert as_preconditioner(P) is P.device_apply()
    op = P.forward
    r = torch.as_tensor(np.random.default_rng(9).standard_normal(A.n_rows))
    np.testing.assert_allclose(as_preconditioner(op)(r).numpy(),
                               op.device_solve_fn()(r).numpy())
    r0 = torch.ones(3)
    assert as_preconditioner(None)(r0) is r0

    class HostOnly:
        def solve(self, v):
            return 2.0 * v

    lifted = as_preconditioner(HostOnly())
    out = lifted(torch.ones(3, dtype=torch.float32))
    assert out.dtype == torch.float32 and out.tolist() == [2.0, 2.0, 2.0]
    assert solve_callback(lambda v: v + 1)(torch.zeros(2)).tolist() == \
        [1.0, 1.0]
    with pytest.raises(TypeError, match="cannot interpret"):
        as_preconditioner(3)
