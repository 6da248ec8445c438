"""The port's `sptrsv` against the reference's, on the CPU.

Both packages solve the same matrices (`lung2_like(0.05)`,
`torso2_like(0.05)`, their transposes as the upper triangles) for the
same right-hand sides, made from a seed:

* all four sweeps (`lower` x `transpose`), with `unit_diagonal` and a
  batched (n, 3) right-hand side, within 1e-12 relative to scale: both
  refine in float64 to a residual <= 1e-10 and land within a few ulps;
* `torch.autograd.grad` of `(x * w).sum()` equals `jax.grad` of the
  reference's `sptrsv` (under float64) within 1e-10, in all four sweeps;
* `torch.autograd.gradcheck` and `gradgradcheck` pass in float64 (a
  float64 schedule, so that finite differences see no float32 rounding),
  and a second derivative taken through `create_graph=True` equals the
  explicit A^-T A^-1 product.

A numpy `b` returns float64 numpy; a tensor `b` returns its dtype on its
device.  The `cuda` twin runs the forward and backward solves on a card;
the reference (and JAX, which the card's machine lacks) is imported only
by the tests that hold the port against it.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import sptrsv_level as K
from repro_torch.solver import TriangularOperator, sptrsv, with_unit_diagonal
from repro_torch.sparse import generators

torch.set_num_threads(1)

MATRICES = {"lung2_like(0.05)": lambda g: g.lung2_like(0.05),
            "torso2_like(0.05)": lambda g: g.torso2_like(0.05)}
SWEEPS = [(True, False), (True, True), (False, False), (False, True)]
SOLVE_RTOL = 1e-12
GRAD_RTOL = 1e-10


@pytest.fixture(autouse=True)
def _fresh_caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "port"))
    TriangularOperator.clear_memory_cache()
    yield
    TriangularOperator.clear_memory_cache()


def _pair(name, lower):
    from repro.sparse import generators as ref_gen
    pair = (MATRICES[name](generators), MATRICES[name](ref_gen))
    return pair if lower else tuple(m.transpose() for m in pair)


def _rel(x, x_ref):
    x, x_ref = np.asarray(x), np.asarray(x_ref)
    return np.abs(x - x_ref).max() / max(1.0, np.abs(x_ref).max())


@pytest.mark.parametrize("lower,transpose", SWEEPS)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_sptrsv_matches_reference(name, lower, transpose):
    from repro.solver import sptrsv as ref_sptrsv
    A, A_ref = _pair(name, lower)
    kw = dict(lower=lower, transpose=transpose, chunk=64, max_deps=8)
    rng = np.random.default_rng(11)
    for b in (rng.standard_normal(A.n_rows),
              rng.standard_normal((A.n_rows, 3))):
        x = sptrsv(A, b, device="cpu", **kw)
        assert isinstance(x, np.ndarray) and x.dtype == np.float64
        assert x.shape == b.shape
        assert _rel(x, ref_sptrsv(A_ref, b, cache=False, **kw)) < SOLVE_RTOL
    b = rng.standard_normal(A.n_rows)
    x = sptrsv(A, b, device="cpu", unit_diagonal=True, **kw)
    assert _rel(x, ref_sptrsv(A_ref, b, unit_diagonal=True, cache=False,
                              **kw)) < SOLVE_RTOL


@pytest.mark.parametrize("lower,transpose", SWEEPS)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_grad_matches_jax_grad(name, lower, transpose):
    import jax
    import jax.numpy as jnp
    from repro.solver import sptrsv as ref_sptrsv
    A, A_ref = _pair(name, lower)
    kw = dict(lower=lower, transpose=transpose)
    rng = np.random.default_rng(12)
    b, w = rng.standard_normal(A.n_rows), rng.standard_normal(A.n_rows)
    bt = torch.tensor(b, requires_grad=True)
    x = sptrsv(A, bt, device="cpu", **kw)
    assert x.dtype == torch.float64 and x.device.type == "cpu"
    (g,) = torch.autograd.grad((x * torch.as_tensor(w)).sum(), bt)
    with jax.enable_x64(True):
        g_ref = jax.grad(lambda v: (ref_sptrsv(A_ref, v, cache=False, **kw) *
                                    jnp.asarray(w)).sum())(jnp.asarray(b))
        g_ref = np.asarray(g_ref)
    assert _rel(g.numpy(), g_ref) < GRAD_RTOL
    # the backward pass is the flipped sweep
    flipped = sptrsv(A, w, device="cpu", lower=lower,
                     transpose=not transpose)
    assert _rel(g.numpy(), flipped) < GRAD_RTOL


@pytest.mark.parametrize("lower,transpose", [(True, False), (False, True)])
def test_gradcheck_and_gradgradcheck_in_float64(lower, transpose):
    A = generators.lung2_like(0.01)
    A = A if lower else A.transpose()
    b = torch.tensor(np.random.default_rng(13).standard_normal(A.n_rows),
                     requires_grad=True)

    def f(v):
        return sptrsv(A, v, lower=lower, transpose=transpose, device="cpu",
                      dtype=np.float64)

    assert torch.autograd.gradcheck(f, (b,), fast_mode=True)
    assert torch.autograd.gradgradcheck(lambda v: f(v) ** 2, (b,),
                                        fast_mode=True)


def test_second_order_through_create_graph():
    """The gradient of sum(x^2) is 2 A^-T x, itself differentiable: the
    Hessian 2 A^-T A^-1 applied to ones comes out of a second grad."""
    A = generators.torso2_like(0.05)
    n = A.n_rows
    b = torch.tensor(np.random.default_rng(14).standard_normal(n),
                     requires_grad=True)
    x = sptrsv(A, b, device="cpu")
    (g,) = torch.autograd.grad((x ** 2).sum(), b, create_graph=True)
    assert g.requires_grad
    np.testing.assert_allclose(
        g.detach().numpy(),
        2 * sptrsv(A, x.detach().numpy(), transpose=True, device="cpu"),
        rtol=0, atol=GRAD_RTOL * max(1.0, float(x.detach().abs().max())))
    (h,) = torch.autograd.grad(g.sum(), b)
    want = 2 * sptrsv(A, sptrsv(A, np.ones(n), device="cpu"),
                      transpose=True, device="cpu")
    assert _rel(h.numpy(), want) < GRAD_RTOL


def test_dtypes_devices_and_options():
    A = generators.lung2_like(0.05)
    n = A.n_rows
    b = np.random.default_rng(15).standard_normal(n)
    x32 = sptrsv(A, torch.as_tensor(b, dtype=torch.float32), device="cpu")
    assert x32.dtype == torch.float32 and x32.device.type == "cpu"
    x64 = sptrsv(A, b, device="cpu")
    assert _rel(x32.numpy(), x64) < 1e-6
    x0 = sptrsv(A, b, device="cpu", max_refine=0)
    assert x0.dtype == np.float64 and _rel(x0, x64) < 5e-4
    U = with_unit_diagonal(A)
    assert np.all(U.diagonal() == 1.0) and U.nnz == A.nnz
    with pytest.raises(TypeError, match="DeviceMesh"):    # mesh= is ported
        sptrsv(A, b, device="cpu", mesh=object())
    before = dict(K.LAUNCHES)
    sptrsv(A, b, device="cpu")
    assert K.LAUNCHES["sptrsv_groups"] == before["sptrsv_groups"]


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sptrsv(generators.chain(16), np.ones(16))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("lower,transpose", SWEEPS)
def test_cuda_forward_and_backward(cuda_device, lower, transpose):
    A = generators.lung2_like(0.05)
    A = A if lower else A.transpose()
    rng = np.random.default_rng(16)
    b = torch.tensor(rng.standard_normal(A.n_rows), dtype=torch.float32,
                     device=cuda_device, requires_grad=True)
    w = torch.as_tensor(rng.standard_normal(A.n_rows), dtype=torch.float32,
                        device=cuda_device)
    before = dict(K.LAUNCHES)
    x = sptrsv(A, b, lower=lower, transpose=transpose)
    assert x.device.type == "cuda" and x.dtype == torch.float32
    (g,) = torch.autograd.grad((x * w).sum(), b)
    assert K.LAUNCHES["sptrsv_groups"] > before["sptrsv_groups"]
    assert K.LAUNCHES["plain"] == before["plain"]
    want = sptrsv(A, w.double().cpu().numpy(), lower=lower,
                  transpose=not transpose)
    assert _rel(g.double().cpu().numpy(), want) < 1e-6
