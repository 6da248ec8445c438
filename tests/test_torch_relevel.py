"""The SpTRSV kernel's dependency-exact packing (`pack_groups`) on the CPU.

The packing fuses the schedule compiler's carry chains into whole rows,
re-levels them to the DAG's depth and cuts each step into tiles for the
CUDA kernel's shared-memory ring.  These tests hold it to what the kernel
relies on, at small sizes and with `max_deps=4`, so that carry chains
exist (above all in the transposed factors, whose long columns become
long rows):

* `emulate_packed` (the kernel's per-tile, per-step loop in torch, a
  step's writes visible only at its end) matches the plain version and
  `repro`'s Pallas kernels in interpret mode, within 1e-6 (float32, the
  two sides sum a row's terms in another order: tests/test_kernels.py's
  bound);
* every row is final exactly once, and every dep's row at a strictly
  earlier step (no race inside a step);
* each row keeps the multiset of (dep, coefficient) of the matrix the
  schedule solves: fusion loses or duplicates nothing;
* the packed steps equal `build_levels(...)`'s level count;
* tiles are 16-byte aligned, fit a ring stage, and their headers agree
  with their lanes;
* a row longer than a tile can hold (an arrow matrix's last rows) keeps
  its pairs outside the tiles and solves all the same.

The value refresh (`refresh_packed_values`, for a value update on a
frozen pattern) is held bitwise equal to a fresh `pack_schedule` of the
new schedule, through the plain refresh and `emulate_packed`; a
coefficient that goes 0 -> non-zero or non-zero -> 0 re-packs (the
packing drops zeros and re-levels without them, so a refresh alone would
solve a row before its dependency).

The CUDA kernel itself, and the device refresh, run only on a card
(`cuda` marker).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.portfolio import make_strategy
from repro_torch.core.transform import replay_transform, transform
from repro_torch.kernels import ref, sptrsv_level as K
from repro_torch.precond import factorize
from repro_torch.solver import TriangularOperator
from repro_torch.solver.levelset import pad_rhs, to_device
from repro_torch.solver.operator import _payload_packed, orient_lower
from repro_torch.solver.schedule import (build_schedule,
                                         repack_schedule_values,
                                         schedule_for_csr,
                                         schedule_for_preamble,
                                         schedule_for_transformed)
from repro_torch.sparse import generators
from repro_torch.sparse.csr import from_coo, tril
from repro_torch.sparse.levels import build_levels

from _optional_deps import given, settings, st

torch.set_num_threads(1)

RTOL = ATOL = 1e-6
EMULATE_RTOL = 1e-5         # float32 sweep against the float64 oracle
ARROW_K = 20000             # the arrow's independent rows: its row K reads
                            # all of them, more than a ring stage can hold


def _matrix(name):
    """(lower-triangular L, chunk, max_deps) of a named case."""
    if name == "lung2_like(0.05)":
        return generators.lung2_like(0.05), 32, 4
    if name == "lung2_like(0.05)^T":
        return orient_lower(generators.lung2_like(0.05), "lower", True)[0], \
            32, 4
    if name == "ic0(lung2_like(0.05))^T":          # IC(0)'s backward sweep
        A = generators.spd_from_lower(generators.lung2_like(0.05), seed=0)
        return orient_lower(factorize.ic0(A).L, "lower", True)[0], 64, 4
    if name == "torso2_like(0.04)":
        return generators.torso2_like(0.04), 64, 4
    if name == "banded(96,10)":
        return generators.banded(96, 10, seed=2), 16, 4
    if name == "arrow":
        return _arrow(ARROW_K), 256, 16
    raise KeyError(name)


def _arrow(k, seed=5):
    """Lower-triangular arrow of k + 2 rows: rows 0..k-1 hold only their
    diagonal, row k reads all of them, row k + 1 reads row k and every
    97th of the first k (a long row that still fits a tile)."""
    rng = np.random.default_rng(seed)
    tail = np.arange(0, k, 97)
    rows = np.concatenate([np.full(k, k), np.full(tail.size + 1, k + 1)])
    cols = np.concatenate([np.arange(k), tail, [k]])
    vals = rng.uniform(-1, 1, rows.size) / np.sqrt(k)
    n = k + 2
    return from_coo(np.concatenate([rows, np.arange(n)]),
                    np.concatenate([cols, np.arange(n)]),
                    np.concatenate([vals, 1 + rng.random(n)]), (n, n))


def _case(name):
    """(schedule, strict-lower CSR it solves or None) of a named case."""
    if name.endswith("/avgLevelCost") or name.endswith("/preamble"):
        L = generators.lung2_like(0.05)
        ts = transform(L, make_strategy("avgLevelCost"), validate=False)
        if name.endswith("/preamble"):
            return schedule_for_preamble(ts, chunk=32, max_deps=4)[0], None
        return schedule_for_transformed(ts, chunk=32, max_deps=4), ts.A
    L, chunk, max_deps = _matrix(name)
    return (schedule_for_csr(L, build_levels(L), chunk=chunk,
                             max_deps=max_deps),
            tril(L, keep_diagonal=False))


CASES = ["lung2_like(0.05)", "lung2_like(0.05)^T", "ic0(lung2_like(0.05))^T",
         "torso2_like(0.04)", "banded(96,10)",
         "lung2_like(0.05)/avgLevelCost", "lung2_like(0.05)/preamble"]
SOLVED = CASES[:-1]                 # cases whose matrix is at hand


def _c(n, R, seed):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((n, R) if R else n).astype(np.float32)
    return pad_rhs(torch.as_tensor(c))


def _atol(name, A):
    """Absolute tolerance per row (a column for broadcasting over R) of
    two float32 solves that sum each row's terms in another order: ATOL,
    and on the arrow ATOL times the square root of the row's terms, the
    growth of rounding over a long sum (row K has 20,000)."""
    if name != "arrow":
        return ATOL
    return ATOL * np.sqrt(np.maximum(1, A.row_nnz()))[:, None]


def _plain(sched, c_pad):
    return ref.sptrsv_levels_grouped_ref(to_device(sched, "cpu").groups,
                                         c_pad, sched.n, sched.n_carry)


def _final_step(packed):
    """(rows, step) of every finalized row: tile lanes and free rows."""
    lanes = K.unpack_tiles(packed)
    rows = np.concatenate([packed.free_row.numpy(), lanes["row"]])
    steps = np.concatenate([np.zeros(packed.num_free, np.int64),
                            lanes["step"]])
    return rows, steps, lanes


def _check_race_free(packed, n):
    rows, steps, lanes = _final_step(packed)
    np.testing.assert_array_equal(np.sort(rows), np.arange(n))
    step_of = np.full(n, -1)
    step_of[rows] = steps
    owner = np.repeat(lanes["step"], np.diff(lanes["dep_ptr"]))
    assert (step_of[lanes["dep_idx"]] < owner).all()
    assert steps.max(initial=0) + 1 == packed.num_steps


def _row_deps(rows, idx, coef):
    order = np.lexsort((coef, idx, rows))
    return np.stack([rows[order], idx[order]]), coef[order]


def _check_deps_kept(packed, A):
    rows, _, lanes = _final_step(packed)
    cnt = np.diff(lanes["dep_ptr"])
    got = _row_deps(np.repeat(lanes["row"], cnt), lanes["dep_idx"],
                    lanes["dep_coef"])
    a_rows = np.repeat(np.arange(A.n_rows), A.row_nnz())
    vals = np.asarray(A.data, dtype=np.float32)
    keep = vals != 0
    want = _row_deps(a_rows[keep], np.asarray(A.indices)[keep], vals[keep])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("R", [0, 1, 8])
@pytest.mark.parametrize("name", CASES)
def test_emulator_matches_plain(name, R):
    sched, _ = _case(name)
    c_pad = _c(sched.n, R, seed=R + 1)
    x_plain = _plain(sched, c_pad).numpy()
    packed = K.pack_schedule(sched)
    np.testing.assert_allclose(K.emulate_packed(packed, c_pad).numpy(),
                               x_plain, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("R", [0, 8])
@pytest.mark.parametrize("name", ["lung2_like(0.05)^T", "banded(96,10)",
                                  "lung2_like(0.05)/avgLevelCost"])
def test_emulator_matches_pallas_interpret(name, R):
    import jax.numpy as jnp
    from repro.kernels.sptrsv_level import (sptrsv_groups_pallas,
                                            sptrsv_groups_pallas_multi)
    from repro.solver.levelset import to_device as ref_to_device
    sched, _ = _case(name)
    c_pad = _c(sched.n, R, seed=10 + R)
    kern = sptrsv_groups_pallas_multi if R else sptrsv_groups_pallas
    x_pal = np.asarray(kern(ref_to_device(sched).groups,
                            jnp.asarray(c_pad.numpy()), n=sched.n,
                            n_carry=sched.n_carry, interpret=True))
    x_emu = K.emulate_packed(K.pack_schedule(sched), c_pad).numpy()
    np.testing.assert_allclose(x_emu, x_pal, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", CASES)
def test_every_row_final_once_after_its_deps(name):
    sched, _ = _case(name)
    _check_race_free(K.pack_schedule(sched), sched.n)


@pytest.mark.parametrize("name", SOLVED)
def test_fusion_keeps_each_rows_deps(name):
    sched, A = _case(name)
    _check_deps_kept(K.pack_schedule(sched), A)


@pytest.mark.parametrize("name", SOLVED)
def test_steps_equal_dag_levels(name):
    sched, A = _case(name)
    packed = K.pack_schedule(sched)
    assert packed.num_steps == build_levels(A).num_levels
    assert packed.schedule_steps == sched.num_steps
    assert packed.num_steps <= sched.num_steps


def test_long_rows_fuse_into_one_lane_each():
    sched, A = _case("ic0(lung2_like(0.05))^T")
    assert sched.n_carry > 1                    # the schedule has chains
    packed = K.pack_schedule(sched)
    nnz = A.row_nnz()
    assert packed.long_lanes == int((nnz > K.LONG_DEPS).sum()) > 0
    assert packed.num_lanes == sched.n
    lanes = K.unpack_tiles(packed)
    np.testing.assert_array_equal(np.diff(lanes["dep_ptr"]),
                                  nnz[lanes["row"]])
    assert (lanes["long"] == (nnz[lanes["row"]] > K.LONG_DEPS)).all()


@pytest.mark.parametrize("name", CASES)
def test_tiles_aligned_within_a_stage_and_headers_consistent(name):
    sched, _ = _case(name)
    packed = K.pack_schedule(sched)
    tp = packed.tile_ptr.numpy().astype(np.int64)
    assert tp[0] == 0 and 4 * tp[-1] == packed.tiles.numel()
    nbytes = 16 * np.diff(tp)
    assert (nbytes > 0).all() and (nbytes <= packed.stage_bytes).all()
    assert packed.stage_bytes % 1024 == 0
    assert packed.num_stages * packed.stage_bytes <= K.RING_BYTES
    assert 1 <= packed.num_stages <= K.MAX_STAGES
    lanes = K.unpack_tiles(packed)
    assert lanes["tile_lanes"].sum() + packed.num_free == packed.num_lanes \
        == sched.n
    # each lane flagged last ends its step; a tile's header flag says
    # whether its last lane ends one
    first = 1 if packed.num_free else 0         # the free pass is step 0
    assert lanes["last"].sum() + first == packed.num_steps
    assert lanes["last"][-1]
    tile_of = np.repeat(np.arange(packed.num_tiles), lanes["tile_lanes"])
    tile_end = np.cumsum(lanes["tile_lanes"]) - 1
    np.testing.assert_array_equal(lanes["tile_ends_step"],
                                  lanes["last"][tile_end])
    np.testing.assert_array_equal(
        lanes["step"],
        first + np.concatenate([[0], np.cumsum(lanes["last"])[:-1]]))
    # long lanes lead each step and each tile
    for s in range(first, packed.num_steps):
        long_ = lanes["long"][lanes["step"] == s]
        assert not (np.diff(long_.astype(int)) > 0).any()
    np.testing.assert_array_equal(
        np.bincount(tile_of, weights=lanes["long"],
                    minlength=packed.num_tiles), lanes["tile_long"])
    rounds = -(-np.diff(lanes["dep_ptr"]) // K.LONG_CHUNK)
    np.testing.assert_array_equal(
        packed.step_long,
        np.bincount(lanes["step"] - first, weights=lanes["long"] * rounds))
    np.testing.assert_array_equal(
        packed.step_short,
        np.bincount(lanes["step"] - first, weights=~lanes["long"]))
    # the lane records point inside their tile, past the records, or (a
    # row of more than FAR_DEPS deps) to their pairs in `far`, which
    # they cover once, in order
    w = packed.tiles.numpy()
    far_at = []
    for t in range(packed.num_tiles):
        tw = w[4 * tp[t]:4 * tp[t + 1]]
        rec = tw[4:4 + 4 * tw[0]].reshape(-1, 4).astype(np.int64)
        cnt = rec[:, 3] & 0x7FFFFFFF
        near = rec[:, 2] >= 0
        assert (near == (cnt <= K.FAR_DEPS)).all()
        assert (rec[near, 2] >= 4 + 4 * tw[0]).all()
        assert (rec[near, 2] + 2 * cnt[near] <= tw.size).all()
        far_at += [(~z, c) for z, c in zip(rec[~near, 2], cnt[~near])]
    ends = np.cumsum([c for _, c in far_at], dtype=np.int64)
    np.testing.assert_array_equal([z for z, _ in far_at],
                                  np.concatenate([[0], ends])[:len(far_at)])
    assert 2 * ends[-1:].sum() == packed.far.numel()


@pytest.mark.parametrize("name", CASES)
def test_narrow_steps_share_tiles_and_wide_steps_do_not(name):
    sched, _ = _case(name)
    packed = K.pack_schedule(sched)
    lanes = K.unpack_tiles(packed)
    step_n = np.bincount(lanes["step"])
    step_long = np.bincount(lanes["step"], weights=lanes["long"])
    narrow = (step_n <= K.NARROW_LANES) & (step_long == 0)
    narrow[:1 if packed.num_free else 0] = False    # the free pass's step
    run = lanes["tile_narrow_run"][lanes["tile"]]
    np.testing.assert_array_equal(run, narrow[lanes["step"]])
    # a tile that is no narrow run holds part of one step
    for t in np.flatnonzero(~lanes["tile_narrow_run"]):
        assert np.unique(lanes["step"][lanes["tile"] == t]).size == 1
    # a run ends at a step's end, so no step straddles two tiles
    assert lanes["tile_ends_step"][lanes["tile_narrow_run"]].all()
    if narrow.sum() > 1:
        assert lanes["tile_narrow_run"].sum() < narrow.sum()


def test_free_pass_takes_the_first_level():
    sched, A = _case("lung2_like(0.05)^T")
    packed = K.pack_schedule(sched)
    _, _, lanes = _final_step(packed)
    free = packed.free_row.numpy()
    assert free.size > 0 and (np.diff(free) > 0).all()
    np.testing.assert_array_equal(
        free, np.flatnonzero(build_levels(A).level_of == 0))
    assert lanes["step"].min() == 1


def _carry_group(n=6):
    """Row 5 of a 6-row system split into two partial lanes and a final
    lane, as (row_ids, dep_idx, dep_coef, dinv, carry_in, carry_out)."""
    row = np.array([[0, 1, 2, 3, 4], [6, 6, 6, 6, 6], [6, 6, 6, 6, 6],
                    [5, 6, 6, 6, 6]])
    idx = np.zeros((4, 5, 2), np.int64)
    coef = np.zeros((4, 5, 2), np.float32)
    idx[1, 0], coef[1, 0] = [0, 1], [0.5, 0.25]
    idx[2, 0], coef[2, 0] = [2, 3], [0.125, 1.0]
    idx[3, 0], coef[3, 0] = [4, 0], [2.0, 0.0]
    dinv = np.ones((4, 5), np.float32)
    dinv[1:3] = 0
    cin = np.full((4, 5), 2)
    cout = np.full((4, 5), 3)
    cout[1, 0], cin[2, 0], cout[2, 0], cin[3, 0] = 0, 0, 1, 1
    return [row, idx, coef, dinv, cin, cout]


def test_carry_chain_fuses_in_order():
    g = _carry_group()
    packed = K.pack_groups((tuple(g),), 6, 2)
    assert packed.num_steps == 2 and packed.schedule_steps == 4
    lanes = K.unpack_tiles(packed)
    last = lanes["row"] == 5
    assert lanes["step"][last] == 1
    lo = lanes["dep_ptr"][np.flatnonzero(last)[0]]
    np.testing.assert_array_equal(lanes["dep_idx"][lo:lo + 5], [0, 1, 2, 3, 4])
    c_pad = _c(6, 0, seed=3)
    x_plain = ref.sptrsv_levels_grouped_ref(
        (tuple(torch.as_tensor(a) for a in g),), c_pad, 6, 2)
    np.testing.assert_allclose(K.emulate_packed(packed, c_pad).numpy(),
                               x_plain.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fault, match", [
    ("two_writers", "writers"), ("two_readers", "readers"),
    ("read_before_write", "no later"), ("dangling", "written 1 and read 0"),
    ("reads_unfinished_row", "no earlier step")])
def test_malformed_schedules_raise(fault, match):
    row, idx, coef, dinv, cin, cout = _carry_group()
    if fault == "two_writers":            # a second partial lane -> slot 0
        cout[1, 1] = 0
    elif fault == "two_readers":          # a second final lane <- slot 0
        row[3, 1], cin[3, 1] = 5, 0
    elif fault == "read_before_write":    # slot 1 read in its own step
        row[2, 1], cin[2, 1] = 5, 1
        row[3, 0] = 6
    elif fault == "dangling":             # slot 1 is never read
        cin[3, 0] = 2
    elif fault == "reads_unfinished_row":  # step 1 reads row 5 (step 3)
        idx[1, 0] = [5, 1]
    with pytest.raises(ValueError, match=match):
        K.pack_groups(((row, idx, coef, dinv, cin, cout),), 6, 2)


def test_legacy_single_group_schedule_packs_like_any():
    L = generators.banded(96, 10, seed=2)
    A = tril(L, keep_diagonal=False)
    sched = build_schedule(A, L.diagonal(), build_levels(L).level_of,
                           chunk=16, max_deps=4, legacy_shape=True)
    assert sched.num_groups == 1 and sched.n_carry > 1
    packed = K.pack_schedule(sched)
    assert packed.num_steps == build_levels(L).num_levels
    _check_deps_kept(packed, A)
    c_pad = _c(96, 0, seed=4)
    np.testing.assert_allclose(K.emulate_packed(packed, c_pad).numpy(),
                               _plain(sched, c_pad).numpy(), rtol=RTOL,
                               atol=ATOL)


@settings(max_examples=40, deadline=None)
@given(n=st.integers(1, 60), density=st.floats(0.0, 0.5),
       max_deps=st.integers(1, 6), chunk=st.sampled_from([4, 8, 32]),
       transpose=st.booleans(), seed=st.integers(0, 2**31 - 1))
def test_random_lower_triangular_property(n, density, max_deps, chunk,
                                          transpose, seed):
    rng = np.random.default_rng(seed)
    mask = np.tril(rng.random((n, n)) < density, k=-1)
    r, c = np.nonzero(mask)
    vals = rng.uniform(-1, 1, r.size) / max(1, n)
    L = from_coo(np.concatenate([r, np.arange(n)]),
                 np.concatenate([c, np.arange(n)]),
                 np.concatenate([vals, 1 + rng.random(n)]), (n, n))
    L = orient_lower(L, "lower", transpose)[0]
    A = tril(L, keep_diagonal=False)
    sched = schedule_for_csr(L, build_levels(L), chunk=chunk,
                             max_deps=max_deps)
    packed = K.pack_schedule(sched)
    assert packed.num_steps == build_levels(L).num_levels
    _check_race_free(packed, n)
    _check_deps_kept(packed, A)
    c_pad = _c(n, 2, seed=seed % 1000)
    np.testing.assert_allclose(K.emulate_packed(packed, c_pad).numpy(),
                               _plain(sched, c_pad).numpy(), rtol=RTOL,
                               atol=ATOL)


def test_rows_longer_than_a_stage_keep_their_pairs_outside_the_tiles():
    sched, A = _case("arrow")
    assert sched.n_carry > 1000                 # row K is a chain of links
    packed = K.pack_schedule(sched)
    assert packed.num_steps == build_levels(A).num_levels == 3
    assert packed.far.numel() == 2 * ARROW_K    # row K's pairs, and no other
    assert packed.stage_bytes == K.MIN_STAGE_BYTES
    assert packed.long_lanes == 2
    _check_race_free(packed, sched.n)
    _check_deps_kept(packed, A)
    for R, seed in ((1, 7), (8, 8)):
        c_pad = _c(sched.n, R, seed=seed)
        x_emu = K.emulate_packed(packed, c_pad).numpy()
        x_plain = _plain(sched, c_pad).numpy()
        assert (np.abs(x_emu - x_plain) <=
                _atol("arrow", A) + RTOL * np.abs(x_plain)).all()


def test_legacy_wrapper_packs_the_same_arrays_once():
    g = [torch.as_tensor(a) for a in _carry_group()]
    first = K._legacy_packed((tuple(g),), 6, 2, "cpu")
    assert K._legacy_packed((tuple(g),), 6, 2, "cpu") is first
    copies = K._legacy_packed((tuple(a.clone() for a in g),), 6, 2, "cpu")
    assert copies is not first                  # other tensors: packed anew
    g[2].mul_(2)                                # an in-place write
    other = K._legacy_packed((tuple(g),), 6, 2, "cpu")
    assert other is not first
    np.testing.assert_array_equal(
        K.unpack_tiles(other)["dep_coef"],
        2 * K.unpack_tiles(first)["dep_coef"])


def test_pack_time_is_recorded():
    sched, _ = _case("lung2_like(0.05)^T")
    packed = K.pack_schedule(sched)
    assert packed.pack_s > 0
    ds = to_device(sched, "cpu")
    assert ds.packed().pack_s > 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 3, 8])
@pytest.mark.parametrize("name", ["ic0(lung2_like(0.05))^T",
                                  "lung2_like(0.05)^T", "banded(96,10)",
                                  "arrow"])
def test_cuda_kernel_on_long_rows_matches_plain(cuda_device, name, R):
    sched, A = _case(name)
    ds = to_device(sched, cuda_device)
    packed = K.pack_schedule(sched).to(cuda_device)
    c_pad = _c(sched.n, R, seed=40 + R).to(cuda_device).contiguous()
    before = dict(K.LAUNCHES)
    x = K.sptrsv_groups_multi(ds.groups, c_pad, n=sched.n,
                              n_carry=sched.n_carry, packed=packed)
    torch.cuda.synchronize()
    assert K.LAUNCHES == dict(before, sptrsv_groups_multi=before[
        "sptrsv_groups_multi"] + 1)
    x_plain = _plain(sched, c_pad.cpu()).numpy()
    assert (np.abs(x.cpu().numpy() - x_plain) <=
            _atol(name, A) + RTOL * np.abs(x_plain)).all()


@pytest.mark.cuda
def test_cuda_kernel_takes_a_misaligned_rhs(cuda_device):
    # float4 gathers (R % 4 == 0) need 16-byte rows: a c_pad that starts
    # 4 bytes into its storage is copied first, and solves all the same
    sched, _ = _case("ic0(lung2_like(0.05))^T")
    packed = K.pack_schedule(sched).to(cuda_device)
    c = _c(sched.n, 8, seed=9)
    flat = torch.zeros(c.numel() + 1, dtype=torch.float32)
    flat[1:] = c.reshape(-1)
    c_pad = flat.to(cuda_device)[1:].view(c.shape)
    assert c_pad.data_ptr() % 16 != 0
    x = K.sptrsv_groups_multi(None, c_pad, n=sched.n, n_carry=sched.n_carry,
                              packed=packed)
    np.testing.assert_allclose(x.cpu().numpy(), _plain(sched, c).numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", CASES)
def test_consumer_threads_are_whole_warps_within_a_block(name):
    sched, _ = _case(name)
    packed = K.pack_schedule(sched)
    for R in (1, 8, 32):
        threads = K.consumer_threads(packed, R)
        assert threads % 32 == 0 and 32 <= threads <= K.MAX_CONSUMERS
        assert packed.consumers[R] == threads
    wide = K.pack_schedule(_case("torso2_like(0.04)")[0])
    assert K.consumer_threads(wide, 8) >= K.consumer_threads(wide, 1)


# -- the value refresh of a packed schedule, and the zero trap ----------------

def _revalued(M, seed=1, diag_scale=1.6):
    """Same pattern, perturbed values, scaled diagonal."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(M.n_rows), M.row_nnz())
    d_mask = M.indices == rows
    data = M.data * (1.0 + 0.25 * rng.standard_normal(M.nnz))
    data[d_mask] = M.data[d_mask] * diag_scale
    return M.with_data(data)


def _rel(x, x_ref):
    return np.abs(x - x_ref).max() / max(1.0, np.abs(x_ref).max())


def _refresh_case(name):
    """(schedule, the same schedule with new values on its layout) for a
    refresh: lung2's and torso2's transformed systems (carry chains at
    max_deps=4), the T-factor preamble, and an arrow whose long row keeps
    its pairs in `far`."""
    if name == "arrow":
        M = _arrow(ARROW_K)
        sched = schedule_for_csr(M, build_levels(M), chunk=256, max_deps=16)
        M2 = _revalued(M, seed=2)
        A2 = tril(M2, keep_diagonal=False)
        return sched, repack_schedule_values(sched, A2.data,
                                             M2.diagonal_fast())
    mat, strat = name.split("/")[:2]
    L = getattr(generators, mat.split("(")[0])(0.05)
    ts = transform(L, make_strategy(strat), validate=False)
    r = replay_transform(_revalued(L, seed=6), ts)
    if name.endswith("/preamble"):
        psched, _, _ = schedule_for_preamble(ts, chunk=32, max_deps=4)
        return psched, repack_schedule_values(psched, r.T.data,
                                              np.ones(r.T.n_rows))
    sched = schedule_for_transformed(ts, chunk=32, max_deps=4)
    return sched, repack_schedule_values(sched, r.A.data, r.diag)


REFRESH_CASES = ["lung2_like(0.05)/no_rewriting",
                 "lung2_like(0.05)/avgLevelCost",
                 "lung2_like(0.05)/avgLevelCost/preamble",
                 "torso2_like(0.05)/avgLevelCost", "arrow"]
PACKED_ARRAYS = ("tiles", "tile_ptr", "far", "free_row", "free_dinv")


def _assert_packed_equal(a, b):
    for name in PACKED_ARRAYS:
        assert torch.equal(getattr(a, name).cpu(), getattr(b, name).cpu()), \
            name
    assert a.num_steps == b.num_steps


@pytest.mark.parametrize("name", REFRESH_CASES)
def test_refresh_equals_a_fresh_pack(name):
    sched, new = _refresh_case(name)
    packed = K.pack_schedule(sched)
    tiles_before = packed.tiles.clone()
    before = dict(K.PACKS)
    got, repacked = K.refresh_packed_values(packed, new)
    assert not repacked
    assert K.PACKS["pack_groups"] == before["pack_groups"]
    assert K.PACKS["refreshes"] == before["refreshes"] + 1
    assert torch.equal(packed.tiles, tiles_before)     # never in place
    assert got.tile_ptr is packed.tile_ptr and got.values is packed.values
    _assert_packed_equal(got, K.pack_schedule(new))
    if name == "arrow":
        assert got.far.numel() > 0
    c = pad_rhs(torch.as_tensor(np.random.default_rng(1).standard_normal(
        new.n), dtype=torch.float32))
    x = K.emulate_packed(got, c)
    xp = ref.sptrsv_levels_grouped_ref(to_device(new, "cpu").groups, c,
                                       new.n, new.n_carry)
    np.testing.assert_allclose(x.numpy(), xp.numpy(), rtol=1e-5, atol=1e-5)


def test_refresh_rejects_another_layout():
    sched, _ = _refresh_case("lung2_like(0.05)/no_rewriting")
    other, _ = _refresh_case("lung2_like(0.05)/avgLevelCost")
    with pytest.raises(ValueError, match="value slots"):
        K.refresh_packed_values(K.pack_schedule(sched), other)


def _zero_trap(zero_first: bool):
    """lung2_like(0.05) L under no_rewriting with one dependency's
    coefficient 0 before the update (zero_first) or after it: (L_before,
    L_after, schedule before, schedule after, the entry)."""
    L = generators.lung2_like(0.05)
    rows = np.repeat(np.arange(L.n_rows), L.row_nnz())
    off = np.flatnonzero(rows != L.indices)
    k = int(off[off.size // 2])
    zeroed = L.data.copy()
    zeroed[k] = 0.0
    L0, L1 = (L.with_data(zeroed), L) if zero_first else \
        (L, L.with_data(zeroed))
    ts = transform(L0, make_strategy("no_rewriting"), validate=False)
    r = replay_transform(L1, ts)
    sched = schedule_for_transformed(ts, chunk=32, max_deps=4)
    return L0, L1, sched, repack_schedule_values(sched, r.A.data, r.diag), k


def _oracle(L, b):
    import scipy.sparse as sp
    from scipy.sparse.linalg import spsolve_triangular
    M = sp.csr_matrix((L.data, L.indices, L.indptr), shape=L.shape)
    return spsolve_triangular(M, b, lower=True)


@pytest.mark.parametrize("zero_first", [True, False],
                         ids=["zero_to_nonzero", "nonzero_to_zero"])
def test_zero_set_change_repacks(zero_first):
    L0, L1, sched, new, _ = _zero_trap(zero_first)
    packed = K.pack_schedule(sched)
    before = dict(K.PACKS)
    got, repacked = K.refresh_packed_values(packed, new)
    assert repacked
    assert K.PACKS["repacks"] == before["repacks"] + 1
    assert K.PACKS["pack_groups"] == before["pack_groups"] + 1
    _assert_packed_equal(got, K.pack_schedule(new))
    b = np.random.default_rng(3).standard_normal(L1.n_rows)
    x_ref = _oracle(L1, b)
    x = K.emulate_packed(got, pad_rhs(torch.as_tensor(b,
                                                      dtype=torch.float32)))
    assert _rel(x.numpy(), x_ref) < EMULATE_RTOL
    if zero_first:
        # the trap: the new values scattered into the old packing (the
        # dependency that was 0 is not in it) give a finite, wrong answer
        vm = packed.values
        v = torch.from_numpy(K.schedule_values(new).astype(np.float32))
        tiles = packed.tiles.clone()
        tiles.view(torch.float32)[torch.from_numpy(vm.tile_word)] = \
            v[torch.from_numpy(vm.tile_src)]
        stale = dataclasses.replace(packed, tiles=tiles,
                                    free_dinv=v[torch.from_numpy(
                                        vm.free_src)])
        x_stale = K.emulate_packed(stale, pad_rhs(torch.as_tensor(
            b, dtype=torch.float32)))
        assert torch.isfinite(x_stale).all()
        assert _rel(x_stale.numpy(), x_ref) > 100 * EMULATE_RTOL


@pytest.mark.parametrize("zero_first", [True, False],
                         ids=["zero_to_nonzero", "nonzero_to_zero"])
def test_update_values_repacks_when_the_zero_set_moves(zero_first):
    """The operator's path: a payload that holds the packed schedules (as
    one built on a card does) refreshes them on update_values, and counts
    a re-pack when the zero set moved."""
    L0, L1, _, _, _ = _zero_trap(zero_first)
    op = TriangularOperator.from_csr(L0, "no_rewriting", device="cpu",
                                     cache=False)
    base = _payload_packed(op._payload, "packed")
    op.update_values(L1)
    assert op.stats.repacks == 1
    assert op._payload["packed"] is not base
    _assert_packed_equal(op._payload["packed"], K.pack_schedule(op.schedule))
    b = np.random.default_rng(4).standard_normal(L1.n_rows)
    assert _rel(op.solve(b), _oracle(L1, b)) < 1e-8
    op.update_values(_revalued(L1, seed=8, diag_scale=1.0))
    assert op.stats.repacks == 1 and op.stats.value_updates == 2


@pytest.mark.cuda
@pytest.mark.parametrize("name", REFRESH_CASES)
def test_cuda_device_refresh_equals_a_fresh_pack(cuda_device, name):
    sched, new = _refresh_case(name)
    packed = K.pack_schedule(sched).to(cuda_device)
    got, repacked = K.refresh_packed_values(packed, new)
    assert not repacked and got.tiles.device.type == "cuda"
    _assert_packed_equal(got, K.pack_schedule(new))
    c = pad_rhs(torch.as_tensor(np.random.default_rng(1).standard_normal(
        new.n), dtype=torch.float32, device=cuda_device)).contiguous()
    x = K.sptrsv_groups(None, c, n=new.n, n_carry=new.n_carry, packed=got)
    xp = K.emulate_packed(got, c)
    torch.cuda.synchronize()
    assert _rel(x.cpu().numpy(), xp.cpu().numpy()) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("zero_first", [True, False],
                         ids=["zero_to_nonzero", "nonzero_to_zero"])
def test_cuda_update_values_through_the_zero_trap(cuda_device, zero_first):
    L0, L1, _, _, _ = _zero_trap(zero_first)
    op = TriangularOperator.from_csr(L0, "no_rewriting", device="cuda",
                                     cache=False)
    before = dict(K.PACKS)
    op.update_values(L1)
    assert op.stats.repacks == 1
    assert K.PACKS["repacks"] == before["repacks"] + 1
    b = np.random.default_rng(4).standard_normal(L1.n_rows)
    x_ref = _oracle(L1, b)
    assert _rel(op.solve(b, max_refine=0), x_ref) < 5e-4
    assert _rel(op.solve(b), x_ref) < 1e-8
    before = dict(K.PACKS)
    op.update_values(_revalued(L1, seed=8, diag_scale=1.0))
    assert K.PACKS["pack_groups"] == before["pack_groups"]
    assert op.stats.repacks == 1
