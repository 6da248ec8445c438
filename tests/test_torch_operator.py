"""The port's TriangularOperator against the reference's, on the CPU.

Both packages build operators for the same matrices and the same fixed
strategies in all four sweeps (lower/upper x transpose).  Tolerances:
refined solves reach a relative residual <= 1e-10 and agree with the
float64 sequential oracle to 1e-8 (the reference's own bounds,
tests/test_operator.py); float32 device outputs (`max_refine=0`,
`device_solve_fn`) agree with the reference's float32 outputs to 1e-5
relative to scale, since the two sum each row's terms in a different
order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.solver import TriangularOperator as RefOperator
from repro.solver import solve_csr_seq
from repro.solver.engines import PallasEngine
from repro.solver.operator import OperatorStats as RefStats
from repro.solver.operator import orient_lower as ref_orient_lower
from repro.sparse import generators as ref_gen

from repro_torch.core.resilience import NumericalHealthError
from repro_torch.kernels import sptrsv_level as K
from repro_torch.solver import TriangularOperator, engines
from repro_torch.solver.levelset import to_device
from repro_torch.solver.operator import OperatorStats
from repro_torch.solver.schedule import schedule_for_csr
from repro_torch.sparse import build_levels
from repro_torch.sparse import generators

torch.set_num_threads(1)

SWEEPS = [("lower", False), ("lower", True), ("upper", False),
          ("upper", True)]
F32_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_memory_cache():
    TriangularOperator.clear_memory_cache()
    RefOperator.clear_memory_cache()
    yield
    TriangularOperator.clear_memory_cache()
    RefOperator.clear_memory_cache()


MATRICES = {"lung2_like(0.04)": lambda g: g.lung2_like(0.04),
            "torso2_like(0.04)": lambda g: g.torso2_like(0.04)}


def _matrices(name, side):
    """The same matrix from both packages' generators (the seeds match,
    tests/test_torch_host_copy.py): (port CSR, reference CSR)."""
    pair = (MATRICES[name](generators), MATRICES[name](ref_gen))
    return pair if side == "lower" else tuple(m.transpose() for m in pair)


def _oracle(A, side, transpose, b):
    """float64 sequential reference for any sweep (reference package)."""
    L_eff, rev = ref_orient_lower(A, side, transpose)
    v = b[::-1] if rev else b
    x = solve_csr_seq(L_eff, v) if b.ndim == 1 else np.stack(
        [solve_csr_seq(L_eff, v[:, j]) for j in range(b.shape[1])], axis=1)
    return x[::-1] if rev else x


def _rel(x, x_ref):
    return np.abs(x - x_ref).max() / max(1.0, np.abs(x_ref).max())


@pytest.mark.parametrize("strategy", ["no_rewriting", "avgLevelCost"])
@pytest.mark.parametrize("side,transpose", SWEEPS)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_operator_matches_reference(name, side, transpose, strategy,
                                    tmp_path):
    A, A_ref = _matrices(name, side)
    kw = dict(side=side, transpose=transpose, chunk=64, max_deps=8)
    op = TriangularOperator.from_csr(A, strategy, device="cpu", **kw)
    ref = RefOperator.from_csr(A_ref, strategy, cache_dir=tmp_path, **kw)
    assert op.device.type == "cpu" and op.engine == "torch"
    assert op.schedule.num_steps == ref.schedule.num_steps
    rng = np.random.default_rng(7)
    b = rng.standard_normal(A.n_rows)

    x = op.solve(b)
    assert x.dtype == np.float64 and op.stats.last_residual <= 1e-10
    assert _rel(x, _oracle(A_ref, side, transpose, b)) < 1e-8

    x0 = op.solve(b, max_refine=0)
    x0_ref = ref.solve(b, max_refine=0)
    assert x0.dtype == np.float32
    assert _rel(x0, x0_ref) < F32_RTOL

    xd = op.device_solve_fn()(torch.as_tensor(b, dtype=torch.float32))
    xd_ref = np.asarray(ref.device_solve_fn()(jnp.asarray(b, jnp.float32)))
    assert xd.dtype == torch.float32
    assert _rel(xd.numpy(), xd_ref) < F32_RTOL

    B = rng.standard_normal((A.n_rows, 3))
    X = op.solve(B)
    assert X.shape == B.shape and op.stats.last_residual <= 1e-10
    assert _rel(X, _oracle(A_ref, side, transpose, B)) < 1e-8
    XD = op.device_solve_fn()(torch.as_tensor(B, dtype=torch.float32))
    XD_ref = np.asarray(ref.device_solve_fn()(jnp.asarray(B, jnp.float32)))
    assert _rel(XD.numpy(), XD_ref) < F32_RTOL
    assert op.stats.solves == 3 and op.stats.rhs_columns == 5


@pytest.mark.parametrize("strategy", ["no_rewriting", "avgLevelCost"])
def test_transposed_is_the_adjoint_sweep(strategy):
    L = generators.lung2_like(0.04)
    op = TriangularOperator.from_csr(L, strategy, device="cpu", chunk=64,
                                     max_deps=8)
    opT = op.transposed()
    assert opT.transpose and opT.side == "lower"
    assert opT.device == op.device and opT.engine == op.engine
    b = np.random.default_rng(3).standard_normal(L.n_rows)
    assert _rel(opT.solve(b), _oracle(ref_gen.lung2_like(0.04), "lower",
                                      True, b)) < 1e-8
    assert not opT.transposed().transpose


def test_memory_cache_hit_shares_the_payload():
    L = generators.lung2_like(0.04)
    op1 = TriangularOperator.from_csr(L, "avgLevelCost", device="cpu")
    op2 = TriangularOperator.from_csr(L, "avgLevelCost", device="cpu")
    assert op1.stats.cache_source == "built"
    assert op2.stats.cache_source == "memory"
    assert op2.schedule is op1.schedule
    op3 = TriangularOperator.from_csr(L, "avgLevelCost", device="cpu",
                                      cache=False)
    assert op3.stats.cache_source == "built"


def test_float64_schedule_on_the_plain_engine():
    L = generators.lung2_like(0.04)
    op = TriangularOperator.from_csr(L, "no_rewriting", device="cpu",
                                     dtype=np.float64)
    b = np.random.default_rng(5).standard_normal(L.n_rows)
    x = op.solve(b, max_refine=0)
    assert x.dtype == np.float64
    assert _rel(x, solve_csr_seq(ref_gen.lung2_like(0.04), b)) < 1e-12


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TriangularOperator.from_csr(generators.chain(16), "no_rewriting")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TriangularOperator.from_csr(generators.chain(16), "no_rewriting",
                                    device="cuda")


def test_cuda_engine_on_cpu_raises_and_never_serves_plain():
    before = dict(K.LAUNCHES)
    with pytest.raises(ValueError, match="does not run on cpu"):
        TriangularOperator.from_csr(generators.chain(16), "no_rewriting",
                                    device="cpu", engine="cuda")
    op = TriangularOperator.from_csr(generators.chain(16), "no_rewriting",
                                     device="cpu")
    with pytest.raises(ValueError, match="runs on"):
        op.solve(np.ones(16), engine="cuda")
    with pytest.raises(ValueError, match="runs on"):
        op.device_solve_fn(engine="cuda")
    assert "torch" not in op._runtime["compiled"]
    assert K.LAUNCHES == before
    with pytest.raises(ValueError, match="unknown engine"):
        op.solve(np.ones(16), engine="scan")


def test_tune_auto_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TriangularOperator.from_csr(generators.chain(16), device="cpu")


def test_health_guard_raises():
    op = TriangularOperator.from_csr(generators.chain(16), "no_rewriting",
                                     device="cpu")
    b = np.ones(16)
    b[3] = np.nan
    with pytest.raises(NumericalHealthError) as info:
        op.solve(b)
    assert info.value.stage == "input"
    assert op.solve(b, health="off", max_refine=0).shape == (16,)
    with pytest.raises(ValueError, match="must be"):
        op.solve(np.ones(15))


def test_stats_fields_match_reference():
    assert OperatorStats._FIELDS == RefStats._FIELDS
    d = OperatorStats(cache_source="built").to_dict()
    assert tuple(d) == RefStats._FIELDS and d["solves"] == 0


def test_engine_registry_and_capabilities():
    assert set(engines.registered_engines()) == {"cuda", "torch"}
    cuda, plain = engines.get_engine("cuda"), engines.get_engine("torch")
    assert cuda.capabilities()["dtypes"] == list(PallasEngine.dtypes)
    assert cuda.capabilities()["available"] == torch.cuda.is_available()
    assert plain.capabilities()["dtypes"] == ["float32", "float64"]
    assert cuda.cache_token() == "cuda"
    assert engines.resolve_engine(None, device="cpu") is plain
    assert engines.resolve_engine(plain) is plain
    with pytest.raises(ValueError, match="registered engines"):
        engines.get_engine("pallas")
    with pytest.raises(ValueError, match="already registered"):
        engines.register_engine(engines.TorchEngine())
    with pytest.raises(TypeError):
        engines.resolve_engine(3)
    L = generators.chain(12)
    ds = to_device(schedule_for_csr(L, build_levels(L), dtype=np.float64),
                   "cpu")
    with pytest.raises(ValueError, match="float64"):      # never a cast
        cuda.compile(ds)
    x = plain.compile(ds)(torch.ones(12, dtype=torch.float64))
    assert x.dtype == torch.float64
