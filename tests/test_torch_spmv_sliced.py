"""K4's sliced ELL form: the packers, the kernel's emulator and the cache.

`pack_sliced` (ELL arrays) and `pack_sliced_csr` (a CSR, never building
the ELL) must give equal arrays; the packed form must hold every row once,
each row's slots in their ELL order, only true padding dropped, slices
column-major and padded with (sentinel, 0).  `emulate_sliced` runs the CUDA
kernel's per-warp loop in torch and is held against the plain version and
the reference's Pallas kernel in interpret mode, in float32 and float64, at
phase 3's tolerances relative to scale (1e-6, 1e-12: the sums run in
another order).  JAX and the reference are imported only inside the tests
that use them, so the `cuda` tests here run on a card without JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import spmv_ell as K4
from repro_torch.sparse import generators

torch.set_num_threads(1)

RTOL = {np.float32: 1e-6, np.float64: 1e-12}
KINDS = ["random", "skewed", "empty_rows", "padding_between", "explicit_zeros"]


def _ell(kind: str, dtype, seed: int = 0):
    """ELL arrays (n_pad, D) and x_pad (n_cols + 1,) for `kind`, from a seed;
    sentinel = n_cols.  No n_pad is a multiple of 32 or of SIGMA."""
    rng = np.random.default_rng(seed)
    n_pad, n_cols = {"random": (300, 290), "skewed": (333, 700),
                     "empty_rows": (777, 777), "padding_between": (301, 260),
                     "explicit_zeros": (95, 120)}[kind]
    if kind == "skewed":
        # one row of 500, rows just below, at and above LONG_SLOTS
        lens = rng.integers(0, 6, n_pad)
        lens[17] = 500
        for r, k in zip((3, 40, 41, 77, 200, 332), (30, 31, 32, 33, 34, 64)):
            lens[r] = k
    elif kind == "empty_rows":
        lens = np.where(rng.random(n_pad) < 0.6, 0, rng.integers(1, 9, n_pad))
        lens[64:160] = 0                     # whole slices of empty rows
    else:
        lens = rng.integers(0, 12, n_pad)
    D = int(lens.max()) + (3 if kind == "padding_between" else 0)
    idx = np.full((n_pad, D), n_cols, dtype=np.int32)
    coef = np.zeros((n_pad, D), dtype=dtype)
    for r, k in enumerate(lens):
        idx[r, :k] = rng.choice(n_cols, size=k, replace=k > n_cols)
        coef[r, :k] = rng.standard_normal(k)
        if kind == "padding_between":
            perm = rng.permutation(D)        # padding among the real slots
            idx[r], coef[r] = idx[r, perm], coef[r, perm]
        if kind == "explicit_zeros":
            coef[r, :k][rng.random(k) < 0.3] = 0.0
    x_pad = np.append(rng.standard_normal(n_cols), 0.0).astype(dtype)
    return idx, coef, x_pad


def _tensors(kind, dtype, seed=0):
    return tuple(torch.as_tensor(a) for a in _ell(kind, dtype, seed))


def _rel(y, y_ref) -> float:
    y, y_ref = np.asarray(y, np.float64), np.asarray(y_ref, np.float64)
    return float(np.abs(y - y_ref).max()) / max(1.0, float(np.abs(y_ref).max()))


def _kept_rows(idx, coef, sentinel):
    """Each row's kept (index, coef) pairs in ELL order, from the ELL."""
    keep = (idx != sentinel) | (coef != 0)
    return [list(zip(idx[r][keep[r]].tolist(), coef[r][keep[r]].tolist()))
            for r in range(idx.shape[0])]


def _packed_rows(p: K4.SlicedEll):
    """Each row's stored (index, coef) pairs, read back from the packed
    form as the kernel reads them, and the slice padding it stores."""
    rows, pads = {}, []
    ptr = p.slice_ptr.tolist()
    row_of = p.row_of.tolist()
    idx, coef = p.idx.tolist(), p.coef.tolist()
    for s in range(p.num_slices):
        width = (ptr[s + 1] - ptr[s]) // 32
        for lane in range(32):
            at = [ptr[s] + 32 * d + lane for d in range(width)]
            pairs = [(idx[a], coef[a]) for a in at]
            row = row_of[32 * s + lane]
            if row >= 0:
                assert row not in rows
                rows[row] = pairs
            else:
                pads.extend(pairs)
    lptr, lidx, lcoef = (p.long_ptr.tolist(), p.long_idx.tolist(),
                         p.long_coef.tolist())
    for j, row in enumerate(p.long_rows.tolist()):
        assert row not in rows
        rows[row] = list(zip(lidx[lptr[j]:lptr[j + 1]],
                             lcoef[lptr[j]:lptr[j + 1]]))
    return rows, pads


@pytest.mark.parametrize("kind", KINDS)
def test_pack_invariants(kind):
    idx, coef, x_pad = _ell(kind, np.float64)
    sentinel = x_pad.shape[0] - 1
    p = K4.pack_sliced(torch.as_tensor(idx), torch.as_tensor(coef), sentinel)
    want = _kept_rows(idx, coef, sentinel)
    rows, pads = _packed_rows(p)
    # every row once; each keeps its slots in ELL order, only (sentinel, 0)
    # dropped; what follows a slice row's slots is (sentinel, 0) padding
    assert sorted(rows) == list(range(idx.shape[0]))
    for r, pairs in rows.items():
        assert pairs[:len(want[r])] == want[r]
        assert all(pr == (sentinel, 0.0) for pr in pairs[len(want[r]):])
    assert all(pr == (sentinel, 0.0) for pr in pads)
    assert p.kept == sum(map(len, want))
    assert p.slots == len(p.idx) + len(p.long_idx)
    # long rows are exactly those above LONG_SLOTS
    klen = np.array([len(w) for w in want])
    assert p.long_rows.tolist() == np.flatnonzero(klen > K4.LONG_SLOTS).tolist()
    assert p.long_ptr.tolist() == [0] + np.cumsum(
        klen[klen > K4.LONG_SLOTS]).tolist()
    # slices: 32 lanes, column-major, each as wide as its widest row,
    # rows in (window, longest first, then by row) order
    ptr = p.slice_ptr.numpy()
    assert ptr[0] == 0 and np.all(np.diff(ptr) % 32 == 0)
    row_of = p.row_of.numpy().reshape(-1, 32)
    for s, lanes in enumerate(row_of):
        live = lanes[lanes >= 0]
        assert (ptr[s + 1] - ptr[s]) // 32 == max(klen[live], default=0)
    order = row_of[row_of >= 0]
    assert np.all(row_of.reshape(-1)[len(order):] == -1)
    keys = list(zip(order // K4.SIGMA, -klen[order], order))
    assert keys == sorted(keys)
    for a in (p.slice_ptr, p.row_of, p.idx, p.long_rows, p.long_ptr,
              p.long_idx):
        assert a.dtype == torch.int32
    assert p.coef.dtype == p.long_coef.dtype == torch.float64


def test_skewed_case_has_long_rows_and_straddles_long_slots():
    idx, coef, x_pad = _ell("skewed", np.float32)
    p = K4.pack_sliced(torch.as_tensor(idx), torch.as_tensor(coef),
                       x_pad.shape[0] - 1)
    assert set(p.long_rows.tolist()) >= {17, 77, 200, 332}
    assert not {3, 40, 41} & set(p.long_rows.tolist())
    assert int(p.long_ptr[-1]) >= 500


def _pallas(idx, coef, x_pad):
    import jax
    import jax.numpy as jnp
    from repro.kernels.spmv_ell import spmv_ell_pallas
    with jax.enable_x64(coef.dtype == np.float64):
        return np.asarray(spmv_ell_pallas(
            jnp.asarray(idx), jnp.asarray(coef), jnp.asarray(x_pad),
            block_rows=idx.shape[0], interpret=True))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", KINDS)
def test_emulator_matches_plain_and_pallas(kind, dtype):
    idx, coef, x_pad = _ell(kind, dtype, seed=5)
    it, ct, xt = (torch.as_tensor(a) for a in (idx, coef, x_pad))
    y = K4.emulate_sliced(K4.pack_sliced(it, ct, x_pad.shape[0] - 1), xt)
    assert y.dtype == ct.dtype and y.shape == (idx.shape[0],)
    assert not torch.isnan(y).any()        # every row written
    assert _rel(y, ref.spmv_ell_ref(it, ct, xt)) <= RTOL[dtype]
    y_pal = _pallas(idx, coef, x_pad)
    assert y_pal.dtype == dtype
    assert _rel(y, y_pal) <= RTOL[dtype]


@pytest.mark.parametrize("sigma,long_slots", [(1, 0), (32, 32), (1024, 64),
                                              (7, 3)])
def test_emulator_holds_at_every_window_and_long_threshold(sigma, long_slots):
    it, ct, xt = _tensors("skewed", np.float64, seed=2)
    p = K4.pack_sliced(it, ct, xt.shape[0] - 1, sigma=sigma,
                       long_slots=long_slots)
    assert p.sigma == sigma and p.long_slots == long_slots
    y = K4.emulate_sliced(p, xt)
    assert not torch.isnan(y).any()
    assert _rel(y, ref.spmv_ell_ref(it, ct, xt)) <= RTOL[np.float64]


CSR_CASES = [
    ("random_lower", lambda: generators.random_lower(700, avg_offdiag=3.0,
                                                     seed=1), 512),
    ("lung2_spd", lambda: generators.spd_from_lower(
        generators.lung2_like(0.05), seed=0), 512),
    ("poisson2d", lambda: generators.poisson2d_spd(20, 17), 64),
]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name,make,block", CSR_CASES,
                         ids=[c[0] for c in CSR_CASES])
def test_the_two_packs_agree(name, make, block, dtype):
    m = make()
    ell_idx, ell_coef, n = ops.ell_pack_csr(m, block_rows=block, dtype=dtype)
    a = K4.pack_sliced(torch.as_tensor(ell_idx), torch.as_tensor(ell_coef),
                       m.n_cols)
    b = K4.pack_sliced_csr(m, dtype, block_rows=block)
    assert (a.n_rows, a.sentinel, a.kept) == (b.n_rows, b.sentinel, b.kept) \
        == (ell_idx.shape[0], m.n_cols, m.nnz)
    for f in ("slice_ptr", "row_of", "idx", "coef", "long_rows", "long_ptr",
              "long_idx", "long_coef"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f
    x_pad = torch.as_tensor(np.append(
        np.random.default_rng(3).standard_normal(m.n_cols), 0.0).astype(dtype))
    # against the float64 product: float32 also rounds the values stored
    y = K4.emulate_sliced(b, x_pad)[:n]
    assert _rel(y, m.matvec(x_pad.double().numpy()[:-1])) <= 10 * RTOL[dtype]


def test_csr_pack_keeps_explicit_zeros():
    m = generators.random_lower(200, avg_offdiag=2.0, seed=4)
    m.data[::3] = 0.0
    p = K4.pack_sliced_csr(m, np.float64)
    assert p.kept == m.nnz
    rows, _ = _packed_rows(p)
    for r in range(m.n_rows):
        lo, hi = m.indptr[r], m.indptr[r + 1]
        assert rows[r][:hi - lo] == list(zip(m.indices[lo:hi].tolist(),
                                             m.data[lo:hi].tolist()))


def test_cache_hits_and_repacks_after_an_in_place_write():
    it, ct, xt = _tensors("random", np.float32)
    sentinel = xt.shape[0] - 1
    before = dict(K4.SLICE_PACKS)
    p1 = K4.sliced_for(it, ct, sentinel)
    p2 = K4.sliced_for(it, ct, sentinel)
    assert p2 is p1
    assert K4.SLICE_PACKS == dict(before, packs=before["packs"] + 1,
                                  hits=before["hits"] + 1)
    y1 = K4.emulate_sliced(p1, xt)
    ct.mul_(2.0)
    p3 = K4.sliced_for(it, ct, sentinel)
    assert p3 is not p1 and K4.SLICE_PACKS["packs"] == before["packs"] + 2
    torch.testing.assert_close(K4.emulate_sliced(p3, xt), 2 * y1)
    # a fresh tensor with equal values is another object: packed anew
    K4.sliced_for(it.clone(), ct, sentinel)
    assert K4.SLICE_PACKS["packs"] == before["packs"] + 3


def test_cache_keeps_the_last_eight_argument_sets():
    sets = [_tensors("explicit_zeros", np.float64, seed=s) for s in range(9)]
    before = dict(K4.SLICE_PACKS)
    for it, ct, xt in sets:
        K4.sliced_for(it, ct, xt.shape[0] - 1)
    it, ct, xt = sets[-1]
    K4.sliced_for(it, ct, xt.shape[0] - 1)          # kept
    it, ct, xt = sets[0]
    K4.sliced_for(it, ct, xt.shape[0] - 1)          # evicted: packed again
    assert K4.SLICE_PACKS == dict(before, packs=before["packs"] + 10,
                                  hits=before["hits"] + 1)


def test_launch_and_pack_refuse_bad_input():
    it, ct, xt = _tensors("random", np.float32)
    p = K4.pack_sliced(it, ct, xt.shape[0] - 1)
    before = dict(K4.LAUNCHES)
    with pytest.raises(ValueError, match="emulate_sliced"):
        K4.spmv_sliced(p, xt)
    assert K4.LAUNCHES == before
    with pytest.raises(ValueError, match="sigma"):
        K4.pack_sliced(it, ct, xt.shape[0] - 1, sigma=0)
    bad = it.clone()
    bad[0, 0] = xt.shape[0]                  # one past x_pad's last entry
    with pytest.raises(ValueError, match="out of bounds"):
        K4.pack_sliced(bad, ct, xt.shape[0] - 1)


def test_wrapper_on_the_cpu_stays_the_plain_version():
    it, ct, xt = _tensors("skewed", np.float32)
    before, packs = dict(K4.LAUNCHES), dict(K4.SLICE_PACKS)
    y = K4.spmv_ell(it, ct, xt.double())
    assert K4.LAUNCHES == dict(before, plain=before["plain"] + 1)
    assert K4.SLICE_PACKS == packs
    torch.testing.assert_close(y, ref.spmv_ell_ref(it, ct, xt), rtol=0,
                               atol=0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_kernel_matches_plain_one_launch_a_call(kind, dtype,
                                                     cuda_device):
    it, ct, xt = (a.to(cuda_device) for a in _tensors(kind, dtype, seed=9))
    before = dict(K4.LAUNCHES)
    y = K4.spmv_ell(it, ct, xt)
    torch.cuda.synchronize()
    assert K4.LAUNCHES == dict(before, spmv_ell=before["spmv_ell"] + 1)
    assert y.dtype == ct.dtype and y.shape == (it.shape[0],)
    assert _rel(y.cpu(), ref.spmv_ell_ref(it, ct, xt).cpu()) <= RTOL[dtype]
    p = K4.sliced_for(it, ct, xt.shape[0] - 1)
    assert _rel(y.cpu(), K4.emulate_sliced(p.to("cpu"), xt.cpu())) \
        <= RTOL[dtype]


@pytest.mark.cuda
def test_cuda_kernel_repacks_after_an_in_place_write(cuda_device):
    it, ct, xt = (a.to(cuda_device) for a in _tensors("skewed", np.float32))
    before = dict(K4.SLICE_PACKS)
    y1 = K4.spmv_ell(it, ct, xt)
    K4.spmv_ell(it, ct, xt)
    assert K4.SLICE_PACKS == dict(before, packs=before["packs"] + 1,
                                  hits=before["hits"] + 1)
    ct.mul_(-3.0)
    y2 = K4.spmv_ell(it, ct, xt)
    torch.cuda.synchronize()
    assert K4.SLICE_PACKS["packs"] == before["packs"] + 2
    assert _rel(y2.cpu(), (-3.0 * y1).cpu()) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("sigma,long_slots", [(32, 32), (256, 64),
                                              (1024, 0)])
def test_cuda_sliced_launch_matches_csr_product(sigma, long_slots,
                                                cuda_device):
    m = generators.spd_from_lower(generators.lung2_like(0.05), seed=0)
    p = K4.pack_sliced_csr(m, np.float64, sigma=sigma,
                           long_slots=long_slots).to(cuda_device)
    x = np.random.default_rng(1).standard_normal(m.n_cols)
    before = dict(K4.LAUNCHES)
    y = K4.spmv_sliced(p, torch.as_tensor(np.append(x, 0.0),
                                          device=cuda_device))
    torch.cuda.synchronize()
    assert K4.LAUNCHES == dict(before, spmv_ell=before["spmv_ell"] + 1)
    assert _rel(y.cpu()[:m.n_rows], m.matvec(x)) <= 1e-12
