"""The port's IC(0)/ILU(0) factorizations and Preconditioner against the
reference's, on the CPU.

Factorization is numpy in both packages (the port keeps a copy), so the
factors, the shift and the attempt count must be equal, array for array.
The Preconditioner is fed the reference's own factors through
`factors_from_numpy`, so a mismatch in the sweeps is not confused with
one in the factorization; its host `apply` and its `device_apply` agree
with the reference's within 5e-5 relative to scale: both run the two
sweeps in float32, each summing a row's terms in its own order, so they
differ by float32 rounding carried through two dependent sweeps (about
1e-7 on these matrices; the bound leaves room for larger factors).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.precond import Preconditioner as RefPreconditioner
from repro.precond import factorize as ref_factorize
from repro.solver import TriangularOperator as RefOperator
from repro.sparse import generators as ref_gen
from repro.sparse.csr import CSR as RefCSR
from repro.sparse.csr import from_coo as ref_from_coo

from repro_torch.core.resilience import PatternMismatchError
from repro_torch.precond import (FactorizationBreakdown,
                                 IdentityPreconditioner, Preconditioner,
                                 factorize)
from repro_torch.precond.factorize import factors_from_numpy
from repro_torch.solver import TriangularOperator
from repro_torch.sparse import generators
from repro_torch.sparse.csr import CSR, from_coo

torch.set_num_threads(1)

APPLY_RTOL = 5e-5

PORT = (generators, CSR, from_coo)
REF = (ref_gen, RefCSR, ref_from_coo)


def nonsymmetric(pkg, n=120, seed=7):
    """tests/test_iterative.py's recipe: random SPD values + 0.25 U(-1,1)."""
    gen, csr, _ = pkg
    rng = np.random.default_rng(seed)
    A = gen.random_spd(n, avg_offdiag=2.5, seed=seed)
    return csr(indptr=A.indptr, indices=A.indices,
               data=A.data + 0.25 * rng.uniform(-1, 1, A.nnz),
               shape=A.shape)


def _dense(pkg, D):
    r, c = np.nonzero(D)
    return pkg[2](r, c, D[r, c], D.shape)


SPD = {
    "poisson2d_spd(6,5)": lambda p: p[0].poisson2d_spd(6, 5),
    "poisson3d_spd(3,3,3)": lambda p: p[0].poisson3d_spd(3, 3, 3),
    "random_spd(80)": lambda p: p[0].random_spd(80, seed=3),
    "spd_from_lower(lung2_like(0.01))":
        lambda p: p[0].spd_from_lower(p[0].lung2_like(0.01)),
    # symmetric with a positive diagonal but indefinite: ic0 breaks down
    # and shifts (tests/test_precond.py::indefinite_spd_shaped)
    "indefinite(shift)": lambda p: _dense(p, np.array(
        [[1.0, 2.0, 0.0], [2.0, 1.0, 2.0], [0.0, 2.0, 1.0]])),
}
GENERAL = dict(SPD, **{
    "nonsymmetric(120)": nonsymmetric,
    # ~zero pivots: ilu0 breaks down and shifts
    "tiny_pivots(shift)": lambda p: _dense(p, np.array(
        [[1e-20, 1.0], [1.0, 1e-20]])),
})


def _pair(table, name):
    return table[name](PORT), table[name](REF)


def assert_csr_equal(a, b):
    assert a.shape == b.shape
    for name in ("indptr", "indices", "data"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def assert_factors_equal(fac, ref):
    assert fac.kind == ref.kind
    assert fac.shift == ref.shift and fac.attempts == ref.attempts
    assert_csr_equal(fac.L, ref.L)
    if ref.U is None:
        assert fac.U is None
    else:
        assert_csr_equal(fac.U, ref.U)


@pytest.mark.parametrize("name", sorted(SPD))
def test_ic0_matches_reference(name):
    A, A_ref = _pair(SPD, name)
    assert_csr_equal(A, A_ref)
    fac = factorize.ic0(A)
    assert_factors_equal(fac, ref_factorize.ic0(A_ref))
    assert (fac.shift > 0) == name.endswith("(shift)")


@pytest.mark.parametrize("name", sorted(GENERAL))
def test_ilu0_matches_reference(name):
    A, A_ref = _pair(GENERAL, name)
    fac = factorize.ilu0(A)
    assert_factors_equal(fac, ref_factorize.ilu0(A_ref))
    assert (fac.shift > 0) == (name == "tiny_pivots(shift)")


@pytest.mark.parametrize("kind,name", [
    ("ic0", "poisson3d_spd(3,3,3)"), ("ic0", "indefinite(shift)"),
    ("ilu0", "nonsymmetric(120)"), ("ilu0", "random_spd(80)")])
def test_refactor_matches_reference(kind, name):
    A, A_ref = _pair(GENERAL, name)
    fac = getattr(factorize, kind)(A)
    fac_ref = getattr(ref_factorize, kind)(A_ref)
    # new values on the frozen pattern: a symmetric rescale for ic0 (the
    # indefinite matrix scaled by 1.5 still needs a shift), a random
    # perturbation for ilu0
    if kind == "ic0":
        data = A.data * 1.5
    else:
        data = A.data * (1 + 0.1 * np.random.default_rng(1).uniform(
            -1, 1, A.nnz))
    new = CSR(indptr=A.indptr, indices=A.indices, data=data, shape=A.shape)
    new_ref = RefCSR(indptr=A_ref.indptr, indices=A_ref.indices,
                     data=data.copy(), shape=A_ref.shape)
    got = factorize.refactor(fac, new)
    assert_factors_equal(got, ref_factorize.refactor(fac_ref, new_ref))
    assert got.plan is fac.plan


def test_refactor_rejects_a_new_pattern():
    A = generators.poisson2d_spd(6, 5)
    fac = factorize.ilu0(A)
    with pytest.raises(PatternMismatchError, match="pattern"):
        factorize.refactor(fac, generators.poisson2d_spd(5, 6))
    stripped = factors_from_numpy("ilu0", (fac.L.indptr, fac.L.indices,
                                           fac.L.data),
                                  (fac.U.indptr, fac.U.indices, fac.U.data),
                                  0.0, 1)
    with pytest.raises(ValueError, match="no pattern plan"):
        factorize.refactor(stripped, A)


def test_breakdown_raises_without_shifting():
    A, _ = _pair(SPD, "indefinite(shift)")
    with pytest.raises(FactorizationBreakdown, match="pivot"):
        factorize.ic0(A, max_shift_attempts=0)
    T, _ = _pair(GENERAL, "tiny_pivots(shift)")
    with pytest.raises(FactorizationBreakdown, match="pivot"):
        factorize.ilu0(T, max_shift_attempts=0)


def test_factors_from_numpy_copies_the_arrays():
    fac = factorize.ilu0(nonsymmetric(PORT))
    arrays = [(m.indptr, m.indices, m.data) for m in (fac.L, fac.U)]
    got = factors_from_numpy("ilu0", *arrays, fac.shift, fac.attempts)
    assert_factors_equal(got, fac)
    assert got.plan is None and not np.shares_memory(got.L.data, fac.L.data)
    with pytest.raises(ValueError, match="no U factor"):
        factors_from_numpy("ic0", *arrays, 0.0, 1)
    with pytest.raises(ValueError, match="unknown"):
        factors_from_numpy("ilut", arrays[0], None, 0.0, 1)


# -- the Preconditioner facade ------------------------------------------------

@pytest.fixture(autouse=True)
def _fresh_memory_cache(tmp_path, monkeypatch):
    # the operator's disk tier writes under the test's own directory
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "cache"))
    TriangularOperator.clear_memory_cache()
    RefOperator.clear_memory_cache()
    yield
    TriangularOperator.clear_memory_cache()
    RefOperator.clear_memory_cache()


def _rel(x, x_ref):
    return np.abs(x - x_ref).max() / max(1.0, np.abs(x_ref).max())


def _system(kind):
    if kind == "ic0":
        return (generators.poisson2d_spd(10, 9),
                ref_gen.poisson2d_spd(10, 9))
    return nonsymmetric(PORT), nonsymmetric(REF)


def _carried(ref_fac):
    U = ref_fac.U
    return factors_from_numpy(
        ref_fac.kind, (ref_fac.L.indptr, ref_fac.L.indices, ref_fac.L.data),
        None if U is None else (U.indptr, U.indices, U.data),
        ref_fac.shift, ref_fac.attempts)


@pytest.mark.parametrize("strategy", ["no_rewriting", "avgLevelCost"])
@pytest.mark.parametrize("kind", ["ic0", "ilu0"])
def test_preconditioner_matches_reference(kind, strategy, tmp_path):
    _, A_ref = _system(kind)
    ref_fac = getattr(ref_factorize, kind)(A_ref)
    P_ref = RefPreconditioner.from_factors(ref_fac, tune=strategy,
                                           cache_dir=tmp_path)
    P = Preconditioner.from_factors(_carried(ref_fac), tune=strategy,
                                    device="cpu")
    assert P.strategy == P_ref.strategy == strategy
    assert P.device.type == "cpu"
    assert P.backward.transpose == (kind == "ic0")
    assert P.backward.side == ("lower" if kind == "ic0" else "upper")
    n = A_ref.n_rows
    rng = np.random.default_rng(5)
    for r in (rng.standard_normal(n), rng.standard_normal((n, 3))):
        z = P.apply(r)
        assert z.dtype == np.float64 and z.shape == r.shape
        assert _rel(z, P_ref.apply(r)) < APPLY_RTOL
        zd = P.device_apply()(torch.as_tensor(r, dtype=torch.float32))
        zd_ref = np.asarray(P_ref.device_apply()(jnp.asarray(r,
                                                             jnp.float32)))
        assert zd.dtype == torch.float32
        assert _rel(zd.numpy(), zd_ref) < APPLY_RTOL
    assert P.stats().keys() == P_ref.stats().keys()
    assert P.stats()["forward"]["solves"] == 2


def test_call_dispatches_on_the_input_type():
    A = generators.poisson2d_spd(10, 9)
    P = Preconditioner.ic0(A, tune="no_rewriting", device="cpu")
    r = np.random.default_rng(0).standard_normal(A.n_rows)
    z_host = P(r)
    assert isinstance(z_host, np.ndarray) and z_host.dtype == np.float64
    z_dev = P(torch.as_tensor(r))
    assert isinstance(z_dev, torch.Tensor) and z_dev.dtype == torch.float64
    assert _rel(z_dev.numpy(), z_host) < 1e-6
    assert P.device_apply() is P.device_apply()
    with pytest.raises(ValueError, match="lies on"):
        P.device_apply()(torch.zeros(A.n_rows, device="meta"))
    ident = IdentityPreconditioner()
    assert ident(r) is r and ident.stats() == {"kind": "identity"}


def test_preconditioner_on_the_port_factors():
    """The whole facade from the port's own factorization: the forward and
    backward sweeps compose to M^-1 = (L L^T)^-1 within float32 rounding."""
    A = generators.poisson2d_spd(10, 9)
    P = Preconditioner.ic0(A, tune="avgLevelCost", device="cpu")
    L = P.factors.L.to_dense()
    r = np.random.default_rng(2).standard_normal(A.n_rows)
    z_exact = np.linalg.solve(L @ L.T, r)
    assert _rel(P.apply(r), z_exact) < APPLY_RTOL


def test_not_ported_options_raise():
    A = generators.poisson2d_spd(6, 5)
    fac = factorize.ic0(A)
    # tune="auto", the default, is ported: the pair tuner decides
    assert Preconditioner.ic0(A, device="cpu").report is not None
    assert Preconditioner.from_factors(fac, device="cpu").report is not None
    # mesh= is ported (tests/test_torch_distributed.py); what is no
    # DeviceMesh is refused
    with pytest.raises(TypeError, match="DeviceMesh"):
        Preconditioner.from_factors(fac, tune="no_rewriting", mesh=object(),
                                    device="cpu")
    # refactor is ported (tests/test_torch_refactor.py holds it against
    # the reference): it re-binds both sweeps and returns the preconditioner
    P = Preconditioner.from_factors(fac, tune="no_rewriting", device="cpu")
    assert P.refactor(A) is P
    assert P.forward.stats.value_updates == P.backward.stats.value_updates \
        == 1


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Preconditioner.ic0(generators.poisson2d_spd(6, 5),
                           tune="no_rewriting")
