"""The port's SpTRSV kernels against the reference's.

Schedules are compiled by the JAX package and carried across with
`schedule_from_numpy`; right-hand sides are made with numpy from a seed.
On the CPU the kernel wrappers run their plain PyTorch versions, which are
held against `repro.kernels.ref` and against the Pallas kernels in
interpret mode.  Tolerance: 1e-6 rtol/atol in float32, as
tests/test_kernels.py holds the Pallas kernels against their oracle (the
two sides sum each row's terms in a different order).  The packing
emulator consumes the same packed arrays as the CUDA kernel and must
match the plain version to the same tolerance.  The kernel itself runs
only on a card (`cuda` marker).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AvgLevelCost, transform as ref_transform
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_kernels
from repro.kernels.sptrsv_level import (sptrsv_groups_pallas,
                                        sptrsv_groups_pallas_multi,
                                        sptrsv_levels_pallas)
from repro.solver import schedule_for_csr, schedule_for_transformed, \
    solve_csr_seq
from repro.solver.levelset import to_device as ref_to_device
from repro.sparse import build_levels, generators

from repro_torch.kernels import ops, sptrsv_level as K
from repro_torch.solver.levelset import (pad_rhs, schedule_from_numpy,
                                         to_device)

torch.set_num_threads(1)

RTOL = ATOL = 1e-6


def _sched(name):
    if name == "random_lower(200)":
        L = generators.random_lower(200, avg_offdiag=2.5, seed=200,
                                    max_back=24)
        return schedule_for_csr(L, build_levels(L), chunk=32, max_deps=4)
    if name == "banded(96,10)":           # split rows: carry maps
        L = generators.banded(96, 10, seed=2)
        return schedule_for_csr(L, build_levels(L), chunk=16, max_deps=4)
    if name == "lung2_like(0.05)/avgLevelCost":
        L = generators.lung2_like(0.05)
        ts = ref_transform(L, AvgLevelCost(), validate=False, codegen=False)
        return schedule_for_transformed(ts, chunk=64, max_deps=8)
    if name == "torso2_like(0.04)":       # several width groups
        L = generators.torso2_like(0.04)
        return schedule_for_csr(L, build_levels(L), chunk=64, max_deps=16)
    raise KeyError(name)


SCHEDULES = ["random_lower(200)", "banded(96,10)",
             "lung2_like(0.05)/avgLevelCost", "torso2_like(0.04)"]
WIDTHS = [0, 1, 3, 8]           # 0: a single (n,) right-hand side


def _c(n, R, seed):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((n, R) if R else n).astype(np.float32)
    tail = (R,) if R else ()
    return np.concatenate([c, np.zeros((1,) + tail, np.float32)])


def _port_plain(ds, c_pad):
    kern = K.sptrsv_groups_multi if c_pad.ndim == 2 else K.sptrsv_groups
    return kern(ds.groups, torch.as_tensor(c_pad), n=ds.n,
                n_carry=ds.n_carry).numpy()


@pytest.mark.parametrize("R", WIDTHS)
@pytest.mark.parametrize("name", SCHEDULES)
def test_plain_matches_reference_oracle(name, R):
    sched = _sched(name)
    ds = to_device(schedule_from_numpy(sched), "cpu")
    c_pad = _c(sched.n, R, seed=R + 1)
    before = K.LAUNCHES["plain"]
    x = _port_plain(ds, c_pad)
    assert K.LAUNCHES["plain"] == before + 1
    x_ref = np.asarray(ref_kernels.sptrsv_levels_grouped_ref(
        ref_to_device(sched).groups, jnp.asarray(c_pad), n=sched.n,
        n_carry=sched.n_carry))
    assert x.shape == x_ref.shape and x.dtype == np.float32
    np.testing.assert_allclose(x, x_ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("R", WIDTHS)
@pytest.mark.parametrize("name", SCHEDULES)
def test_plain_matches_pallas_interpret(name, R):
    sched = _sched(name)
    ds = to_device(schedule_from_numpy(sched), "cpu")
    c_pad = _c(sched.n, R, seed=10 + R)
    kern = sptrsv_groups_pallas_multi if R else sptrsv_groups_pallas
    x_pal = np.asarray(kern(ref_to_device(sched).groups, jnp.asarray(c_pad),
                            n=sched.n, n_carry=sched.n_carry,
                            interpret=True))
    np.testing.assert_allclose(_port_plain(ds, c_pad), x_pal, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("R", WIDTHS)
@pytest.mark.parametrize("name", SCHEDULES)
def test_packing_emulator_matches_plain(name, R):
    sched = schedule_from_numpy(_sched(name))
    ds = to_device(sched, "cpu")
    c_pad = torch.as_tensor(_c(sched.n, R, seed=20 + R))
    x_emu = K.emulate_packed(K.pack_schedule(sched), c_pad).numpy()
    np.testing.assert_allclose(x_emu, _port_plain(ds, c_pad.numpy()),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", SCHEDULES)
def test_packing_drops_padding_and_finalizes_every_row_once(name):
    sched = schedule_from_numpy(_sched(name))
    p = K.pack_schedule(sched)
    rows = p.lane_row.numpy()
    final = np.sort(rows[rows < sched.n])
    np.testing.assert_array_equal(final, np.arange(sched.n))
    partial = rows == sched.n                   # split-row leading lanes
    np.testing.assert_array_equal(p.lane_cout.numpy() < sched.n_carry,
                                  partial)
    assert (p.dep_coef.numpy() != 0).all()
    step_ptr = p.step_ptr.numpy()
    assert step_ptr[0] == 0 and step_ptr[-1] == p.num_lanes
    assert p.num_steps == sched.num_steps
    assert p.max_step_lanes == int(np.diff(step_ptr).max())
    assert p.num_deps == sum(int((g.dep_coef != 0).sum())
                             for g in sched.groups)


def test_legacy_flat_wrapper_matches_reference():
    sched = _sched("banded(96,10)")
    assert sched.num_groups == 1 and sched.groups[0].carry_in is not None
    g = sched.groups[0]
    c_pad = _c(sched.n, 0, seed=3)
    leaves = [torch.as_tensor(a) for a in (g.row_ids, g.dep_idx, g.dep_coef,
                                           g.dinv, g.carry_in, g.carry_out)]
    before = dict(K.LAUNCHES)
    x = K.sptrsv_levels(*leaves, leaves[0], torch.as_tensor(c_pad),
                        n=sched.n, n_carry=sched.n_carry).numpy()
    assert K.LAUNCHES == dict(before, plain=before["plain"] + 1)
    jleaves = [jnp.asarray(a) for a in (g.row_ids, g.dep_idx, g.dep_coef,
                                        g.dinv, g.carry_in, g.carry_out)]
    x_ref = np.asarray(ref_kernels.sptrsv_levels_ref(
        *jleaves, jleaves[0], jnp.asarray(c_pad), n=sched.n,
        n_carry=sched.n_carry))
    x_pal = np.asarray(sptrsv_levels_pallas(
        *jleaves, jleaves[0], jnp.asarray(c_pad), n=sched.n,
        n_carry=sched.n_carry, interpret=True))
    np.testing.assert_allclose(x, x_ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(x, x_pal, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("R", [0, 3])
@pytest.mark.parametrize("name", SCHEDULES)
def test_sptrsv_solve_matches_reference_ops(name, R):
    sched = _sched(name)
    c = _c(sched.n, R, seed=30 + R)[:-1]
    x = ops.sptrsv_solve(schedule_from_numpy(sched), c, device="cpu")
    x_pal = ref_ops.sptrsv_solve(sched, c, interpret=True)
    np.testing.assert_allclose(x, x_pal, rtol=RTOL, atol=ATOL)
    x_ref = ops.sptrsv_solve(schedule_from_numpy(sched), c, device="cpu",
                             use_ref=True)
    np.testing.assert_allclose(x, x_ref, rtol=RTOL, atol=ATOL)


def test_sptrsv_solve_against_float64_oracle():
    L = generators.banded(96, 10, seed=2)
    sched = schedule_for_csr(L, build_levels(L), chunk=16, max_deps=4)
    b = np.random.default_rng(0).standard_normal(96)
    x = ops.sptrsv_solve(schedule_from_numpy(sched), b, device="cpu")
    assert np.abs(x - solve_csr_seq(L, b)).max() < 1e-3


def test_sptrsv_solve_needs_a_device_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sched = schedule_from_numpy(_sched("random_lower(200)"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.sptrsv_solve(sched, np.ones(sched.n))


def test_packed_staging_leaves_the_width_groups_unstaged():
    sched = schedule_from_numpy(_sched("banded(96,10)"))
    ds = to_device(sched, "cpu")
    packed = ds.packed()
    assert "groups" not in vars(ds)
    assert packed.num_steps == sched.num_steps
    assert len(ds.groups) == sched.num_groups and "groups" in vars(ds)


def test_plain_version_needs_the_width_groups():
    sched = schedule_from_numpy(_sched("random_lower(200)"))
    packed = K.pack_schedule(sched)
    c_pad = torch.as_tensor(_c(sched.n, 0, seed=5))
    with pytest.raises(ValueError, match="width groups"):
        K.sptrsv_groups(None, c_pad, n=sched.n, n_carry=sched.n_carry,
                        packed=packed)


def test_schedule_from_numpy_copies():
    sched = _sched("banded(96,10)")
    port = schedule_from_numpy(sched)
    assert port.value_plan is not None
    for gp, gr in zip(port.groups, sched.groups, strict=True):
        assert not np.shares_memory(gp.dep_coef, gr.dep_coef)
        np.testing.assert_array_equal(gp.dep_coef, gr.dep_coef)
    assert (port.n, port.n_carry, port.num_steps) == \
        (sched.n, sched.n_carry, sched.num_steps)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("R", WIDTHS)
@pytest.mark.parametrize("name", SCHEDULES)
def test_cuda_kernel_matches_plain(cuda_device, name, R):
    sched = schedule_from_numpy(_sched(name))
    ds = to_device(sched, cuda_device)
    c_pad = torch.as_tensor(_c(sched.n, R, seed=40 + R), device=cuda_device)
    kern = K.sptrsv_groups_multi if R else K.sptrsv_groups
    key = "sptrsv_groups_multi" if R else "sptrsv_groups"
    before = dict(K.LAUNCHES)
    x = kern(ds.groups, c_pad, n=sched.n, n_carry=sched.n_carry,
             packed=ds.packed())
    torch.cuda.synchronize()
    assert K.LAUNCHES[key] == before[key] + 1
    assert K.LAUNCHES["plain"] == before["plain"]
    x_plain = K.ref.sptrsv_levels_grouped_ref(ds.groups, c_pad, sched.n,
                                              sched.n_carry)
    np.testing.assert_allclose(x.cpu().numpy(), x_plain.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_cuda_kernel_rejects_float64(cuda_device):
    sched = schedule_from_numpy(_sched("random_lower(200)"))
    ds = to_device(sched, cuda_device)
    c_pad = pad_rhs(torch.ones(sched.n, dtype=torch.float64,
                               device=cuda_device))
    with pytest.raises(TypeError, match="float32"):
        K.sptrsv_groups(ds.groups, c_pad, n=sched.n, n_carry=sched.n_carry)


@pytest.mark.cuda
def test_cuda_legacy_wrapper_counts_its_launch_once(cuda_device):
    sched = schedule_from_numpy(_sched("banded(96,10)"))
    ds = to_device(sched, cuda_device)
    g = ds.groups[0]
    c_pad = torch.as_tensor(_c(sched.n, 0, seed=6), device=cuda_device)
    before = dict(K.LAUNCHES)
    x = K.sptrsv_levels(*g, g[0], c_pad, n=sched.n, n_carry=sched.n_carry)
    torch.cuda.synchronize()
    assert K.LAUNCHES == dict(before,
                              sptrsv_levels=before["sptrsv_levels"] + 1)
    x_plain = K.ref.sptrsv_levels_grouped_ref(ds.groups, c_pad, sched.n,
                                              sched.n_carry)
    np.testing.assert_allclose(x.cpu().numpy(), x_plain.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
