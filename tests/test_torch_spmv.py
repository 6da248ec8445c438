"""The port's ELL SpMV (K4) against the reference's.

`ell_pack_csr` gives arrays equal to the reference's.  On the CPU the
kernel wrapper runs its plain PyTorch version, which is held against
`repro.kernels.ops.spmv_ell` with the Pallas kernel in interpret mode, at
the JAX suite's own cases and tolerance (tests/test_kernels.py: 1e-6
rtol/atol; the two sides sum each row's terms in a different order).
float64 runs the reference's `spmv_ell_pallas` under
`jax.enable_x64(True)` on float64 ELL arrays.  The CUDA kernel itself runs
only on a card (`cuda` marker).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels.spmv_ell import spmv_ell_pallas
from repro.sparse import generators as ref_gen

from repro_torch.kernels import ops, ref
from repro_torch.kernels import spmv_ell as K4
from repro_torch.sparse import generators

torch.set_num_threads(1)

RTOL = ATOL = 1e-6
CASES = [(100, 2.0, 32), (500, 3.0, 128), (77, 1.0, 16)]   # (n, avg, block)


def _pair(n, avg):
    """The same matrix from both packages' generators, and an x."""
    m = generators.random_lower(n, avg_offdiag=avg, seed=7)
    m_ref = ref_gen.random_lower(n, avg_offdiag=avg, seed=7)
    x = np.random.default_rng(3).standard_normal(n)
    return m, m_ref, x


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,avg,block", CASES)
def test_ell_pack_matches_reference(n, avg, block, dtype):
    m, m_ref, _ = _pair(n, avg)
    got = ops.ell_pack_csr(m, block_rows=block, dtype=dtype)
    want = ref_ops.ell_pack_csr(m_ref, block_rows=block, dtype=dtype)
    assert got[2] == want[2] == n
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert got[0].shape[0] % block == 0


@pytest.mark.parametrize("n,avg,block", CASES)
def test_spmv_ell_matches_pallas_interpret(n, avg, block):
    m, m_ref, x = _pair(n, avg)
    before = dict(K4.LAUNCHES)
    y = ops.spmv_ell(m, x, device="cpu", block_rows=block)
    assert K4.LAUNCHES == dict(before, plain=before["plain"] + 1)
    y_pal = ref_ops.spmv_ell(m_ref, x, interpret=True, block_rows=block)
    assert isinstance(y, np.ndarray) and y.dtype == np.float32
    assert y.shape == y_pal.shape == (n,)
    np.testing.assert_allclose(y, y_pal, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(y, m.matvec(x), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n,avg,block", CASES)
def test_spmv_ell_float64_matches_pallas_interpret(n, avg, block):
    m, m_ref, x = _pair(n, avg)
    idx, coef, _ = ops.ell_pack_csr(m, block_rows=block, dtype=np.float64)
    x_pad = np.concatenate([x, [0.0]])
    y = K4.spmv_ell(torch.as_tensor(idx), torch.as_tensor(coef),
                    torch.as_tensor(x_pad))
    assert y.dtype == torch.float64 and y.shape == (idx.shape[0],)
    with jax.enable_x64(True):
        y_pal = np.asarray(spmv_ell_pallas(
            jnp.asarray(idx), jnp.asarray(coef), jnp.asarray(x_pad),
            block_rows=block, interpret=True))
    assert y_pal.dtype == np.float64
    np.testing.assert_allclose(y.numpy(), y_pal, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(y.numpy()[:n], m.matvec(x), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("n,avg,block", CASES)
def test_plain_matches_reference_oracle(n, avg, block):
    m, m_ref, x = _pair(n, avg)
    y = ops.spmv_ell(m, x, device="cpu", use_ref=True, block_rows=block)
    y_ref = ref_ops.spmv_ell(m_ref, x, use_ref=True, block_rows=block)
    np.testing.assert_allclose(y, y_ref, rtol=RTOL, atol=ATOL)


def test_tensor_input_keeps_its_device():
    m, _, x = _pair(100, 2.0)
    xt = torch.as_tensor(x)
    y = ops.spmv_ell(m, xt, block_rows=32)
    assert isinstance(y, torch.Tensor) and y.device == xt.device
    assert y.dtype == torch.float32 and y.shape == (100,)
    np.testing.assert_allclose(y.numpy(), ops.spmv_ell(m, x, device="cpu",
                                                       block_rows=32))
    with pytest.raises(ValueError, match="lies on"):
        ops.spmv_ell(m, xt, device="meta")
    with pytest.raises(ValueError, match=r"\(100,\)"):
        ops.spmv_ell(m, xt[:50])


def test_numpy_input_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m, _, x = _pair(100, 2.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.spmv_ell(m, x)


def test_wrapper_rejects_bad_arguments():
    idx = torch.zeros((4, 2), dtype=torch.int32)
    coef = torch.zeros((4, 2))
    x_pad = torch.zeros(3)
    with pytest.raises(ValueError, match="n_pad, D"):
        K4.spmv_ell(idx, coef[:, :1], x_pad)
    with pytest.raises(TypeError, match="int32"):
        K4.spmv_ell(idx.long(), coef, x_pad)
    with pytest.raises(TypeError, match="float32 or float64"):
        K4.spmv_ell(idx, coef.half(), x_pad)
    with pytest.raises(ValueError, match=r"\(n\+1,\)"):
        K4.spmv_ell(idx, coef, x_pad[:, None])
    with pytest.raises(ValueError, match="one device"):
        K4.spmv_ell(idx, coef, x_pad.to("meta"))


def test_plain_version_pads_with_the_zero_slot():
    # rows of different degree: padding slots read x_pad's zero last slot
    idx = torch.tensor([[0, 2], [1, 3], [3, 3]], dtype=torch.int32)
    coef = torch.tensor([[2.0, 1.0], [-1.0, 0.0], [0.0, 0.0]])
    x_pad = torch.tensor([1.0, 2.0, 3.0, 0.0])
    y = ref.spmv_ell_ref(idx, coef, x_pad)
    np.testing.assert_array_equal(y.numpy(), [5.0, -2.0, 0.0])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-6),
                                        (np.float64, 1e-12)])
@pytest.mark.parametrize("n,avg,block", CASES)
def test_cuda_kernel_matches_plain(n, avg, block, dtype, rtol, cuda_device):
    m, _, x = _pair(n, avg)
    idx, coef, _ = ops.ell_pack_csr(m, block_rows=block, dtype=dtype)
    args = [torch.as_tensor(a, device=cuda_device)
            for a in (idx, coef, np.concatenate([x, [0.0]]).astype(dtype))]
    before = dict(K4.LAUNCHES)
    y = K4.spmv_ell(*args)
    torch.cuda.synchronize()
    assert K4.LAUNCHES == dict(before, spmv_ell=before["spmv_ell"] + 1)
    y_plain = ref.spmv_ell_ref(*args)
    scale = max(1.0, float(y_plain.abs().max()))
    err = float((y - y_plain).abs().max()) / scale
    assert y.dtype == y_plain.dtype and err <= rtol
