"""The port's static verifier against the reference's, on the CPU, and the
certifier of what the card runs.

* Parity: on the same inputs (the host copies compile equal schedules,
  tests/test_torch_host_copy.py) the port's `ScheduleCertificate` equals
  the reference's field for field, and its transform audit gives the same
  facts, for the four paper strategies on three generators (one with
  carry chains at a small `max_deps`).  One deliberate difference: the
  nnz check counts A' in the schedule dtype, so a float32 schedule whose
  A' holds values below float32's range certifies in the port and is
  refused by the reference.
* Rejection: every static mutator is refused with the same check, step,
  lane and group by both packages, and the four injectors through a
  strict `from_csr` on the CPU raise before anything is packed or
  launched.
* Wiring: the certificate rides the memory and disk tiers (a strict cache
  hit runs the verifier 0 times, counted, not timed), a poisoned value
  re-bind raises and leaves the operator on its old values.
* The packed form: `verify_packed_schedule` certifies CPU packs of every
  case, an arrow whose long row keeps its pairs in `far`, and preambles,
  and refuses hand-made mutations of the tile stream, each with its named
  check; the card's certification flow (`_certify`)
  runs here on host packs.  The `cuda` cases run it on the card.
The JAX package is imported only inside the tests that compare with it,
so that the `cuda` cases run on a card without it.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.analysis import (certificate_dict, verify_level_schedule,
                                  verify_packed_schedule,
                                  verify_packed_values,
                                  verify_schedule_values)
from repro_torch.analysis import verify as V
from repro_torch.analysis.verify import audit_transformed_system
from repro_torch.core import faults
from repro_torch.core.portfolio import make_strategy
from repro_torch.core.resilience import (ScheduleInvariantError,
                                         TransformInvariantError)
from repro_torch.core.transform import transform
from repro_torch.kernels import sptrsv_level as K
from repro_torch.solver import TriangularOperator, validate_schedule
from repro_torch.solver.operator import _certify
from repro_torch.solver.reference import solve_csr_seq
from repro_torch.solver.schedule import (schedule_for_preamble,
                                         schedule_for_transformed)
from repro_torch.sparse import generators
from repro_torch.sparse.csr import from_coo

torch.set_num_threads(1)

STRATEGIES = ("no_rewriting", "avgLevelCost", "constrained_avg",
              "critical_path")
# name -> (generator call on a generators module, chunk, max_deps)
CASES = {
    "banded(200,5)": (lambda g: g.banded(n=200, bandwidth=5, seed=7), 32, 4),
    "lung2_like(0.05)": (lambda g: g.lung2_like(0.05), 64, 16),
    # rows of up to 12 deps split into carry chains of 2-dep links
    "random_lower(300)": (lambda g: g.random_lower(
        300, avg_offdiag=4.0, seed=5, max_back=30), 32, 2),
}
INJECTORS = (("reorder_schedule_step", ScheduleInvariantError, "race"),
             ("duplicate_lane_row", ScheduleInvariantError, "bijection"),
             ("oob_ell_index", ScheduleInvariantError, "index-bounds"),
             ("corrupt_replay_plan", TransformInvariantError,
              "replay-bounds"))


@pytest.fixture(autouse=True)
def _fresh(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "cache"))
    TriangularOperator.clear_memory_cache()
    yield
    TriangularOperator.clear_memory_cache()


def _build(case, strategy):
    gen, chunk, max_deps = CASES[case]
    L = gen(generators)
    ts = transform(L, make_strategy(strategy), validate=False, codegen=False)
    return L, ts, schedule_for_transformed(ts, chunk=chunk,
                                           max_deps=max_deps)


def _ref_build(case, strategy):
    from repro.core.portfolio import make_strategy as ref_make_strategy
    from repro.core.transform import transform as ref_transform
    from repro.solver.schedule import \
        schedule_for_transformed as ref_schedule_for_transformed
    from repro.sparse import generators as ref_gen
    gen, chunk, max_deps = CASES[case]
    ts = ref_transform(gen(ref_gen), ref_make_strategy(strategy),
                       validate=False, codegen=False)
    return ts, ref_schedule_for_transformed(ts, chunk=chunk,
                                            max_deps=max_deps)


def _raised(fn):
    """(type name, check, step, lane, group, message) of what fn raises."""
    try:
        fn()
    except Exception as e:      # the port's or the reference's classes
        return _fields(e)
    raise AssertionError("nothing was raised")


def _fields(e):
    return (type(e).__name__, e.check, getattr(e, "step", None),
            getattr(e, "lane", None), getattr(e, "group", None), str(e))


# -- parity with the reference ------------------------------------------------

@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_certificates_and_audit_facts_equal_the_reference(case, strategy):
    from repro.analysis import certificate_dict as ref_certificate_dict
    from repro.analysis import verify_level_schedule as ref_verify
    from repro.analysis.verify import \
        audit_transformed_system as ref_audit
    _, ts, sched = _build(case, strategy)
    ts_ref, sched_ref = _ref_build(case, strategy)
    for devices in (1, 3):
        got = certificate_dict(verify_level_schedule(sched, ts.A, ts.diag,
                                                     devices=devices))
        want = ref_certificate_dict(ref_verify(sched_ref, ts_ref.A,
                                               ts_ref.diag, devices=devices))
        assert got == want
    assert audit_transformed_system(ts) == ref_audit(ts_ref)
    if case == "random_lower(300)":
        assert sched.n_carry > 0            # the carry chains are checked


def test_float32_underflow_certifies_in_the_port_only():
    """critical_path on torso2_like(0.05) at max_deps 8 leaves 2,729 values
    of A' below float32's range: the float32 schedule holds them as 0,
    which the port counts as such and the reference as lost entries."""
    from repro.analysis import verify_level_schedule as ref_verify
    from repro.core.portfolio import make_strategy as ref_make_strategy
    from repro.core.resilience import ScheduleInvariantError as RefError
    from repro.core.transform import transform as ref_transform
    from repro.solver.schedule import \
        schedule_for_transformed as ref_schedule_for_transformed
    from repro.sparse import generators as ref_gen
    L = generators.torso2_like(0.05)
    ts = transform(L, make_strategy("critical_path"), validate=False)
    sched = schedule_for_transformed(ts, chunk=256, max_deps=8)
    lost = int((ts.A.data.astype(np.float32) == 0).sum())
    assert lost > 0 and not (ts.A.data == 0).any()
    cert = verify_level_schedule(sched, ts.A, ts.diag)
    assert cert.nnz == ts.A.nnz - lost
    ts_ref = ref_transform(ref_gen.torso2_like(0.05),
                           ref_make_strategy("critical_path"),
                           validate=False, codegen=False)
    with pytest.raises(RefError) as ei:
        ref_verify(ref_schedule_for_transformed(ts_ref, chunk=256,
                                                max_deps=8),
                   ts_ref.A, ts_ref.diag)
    assert ei.value.check == "nnz"
    # a value of A' that is lost in float64 too is still refused
    A = dataclasses.replace(ts.A, data=ts.A.data.copy())
    A.data[np.flatnonzero(A.data.astype(np.float32) != 0)[0]] *= 1e-300
    with pytest.raises(ScheduleInvariantError, match=r"\[nnz\]"):
        verify_level_schedule(sched, A, ts.diag)


MUTATORS = {
    "swap_schedule_steps": lambda f, s: f.swap_schedule_steps(s),
    "swap_middle_steps": lambda f, s: f.swap_schedule_steps(s, 3, 9),
    "duplicate_schedule_row": lambda f, s: f.duplicate_schedule_row(s),
    "oob_schedule_index": lambda f, s: f.oob_schedule_index(s),
    "oob_schedule_index_far": lambda f, s: f.oob_schedule_index(s, 10**6),
}


@pytest.mark.parametrize("mutator", sorted(MUTATORS))
@pytest.mark.parametrize("case", ["banded(200,5)", "random_lower(300)"])
def test_mutations_are_refused_like_the_reference(case, mutator):
    from repro.analysis import verify_level_schedule as ref_verify
    from repro.core import faults as ref_faults
    _, ts, sched = _build(case, "avgLevelCost")
    ts_ref, sched_ref = _ref_build(case, "avgLevelCost")
    mutate = MUTATORS[mutator]
    got = _raised(lambda: verify_level_schedule(mutate(faults, sched),
                                                ts.A, ts.diag))
    want = _raised(lambda: ref_verify(mutate(ref_faults, sched_ref),
                                      ts_ref.A, ts_ref.diag))
    assert got == want
    assert got[2] >= 0 and got[3] >= 0
    with pytest.raises(ScheduleInvariantError):
        validate_schedule(mutate(faults, sched), ts.A, ts.diag)


@pytest.mark.parametrize("which", ["poison", "scale"])
def test_value_faults_are_refused_like_the_reference(which):
    from repro.analysis import verify_schedule_values as ref_values
    from repro.core import faults as ref_faults
    _, ts, sched = _build("banded(200,5)", "avgLevelCost")
    ts_ref, sched_ref = _ref_build("banded(200,5)", "avgLevelCost")

    def bad(f, s):
        return f.poison_schedule(s) if which == "poison" else \
            f.scale_schedule(s, 2.0)

    got = _raised(lambda: verify_schedule_values(bad(faults, sched), ts.A,
                                                 ts.diag))
    want = _raised(lambda: ref_values(bad(ref_faults, sched_ref), ts_ref.A,
                                      ts_ref.diag))
    assert got == want
    assert got[1] == ("finite" if which == "poison" else "dinv")


@pytest.mark.parametrize("mode", ["target", "row"])
def test_corrupt_plans_are_refused_like_the_reference(mode):
    from repro.analysis.verify import \
        audit_transformed_system as ref_audit
    from repro.core import faults as ref_faults
    _, ts, _ = _build("banded(200,5)", "avgLevelCost")
    ts_ref, _ = _ref_build("banded(200,5)", "avgLevelCost")
    got = _raised(lambda: audit_transformed_system(
        faults.corrupt_plan(ts, mode)))
    want = _raised(lambda: ref_audit(ref_faults.corrupt_plan(ts_ref, mode)))
    assert got == want and got[1] == "replay-bounds"


def test_collectives_wait_for_the_sharded_lowering():
    """The sharded lowering is ported: collectives=True certifies one
    all_gather family per step, as the reference's certificate does."""
    from repro.analysis.verify import verify_level_schedule as ref_verify
    _, ts, sched = _build("banded(200,5)", "no_rewriting")
    ts_ref, sched_ref = _ref_build("banded(200,5)", "no_rewriting")
    cert = verify_level_schedule(sched, ts.A, ts.diag, collectives=True)
    want = ref_verify(sched_ref, ts_ref.A, ts_ref.diag, collectives=True)
    assert cert.collective_families == sched.num_steps == \
        want.collective_families
    assert cert.checks[-1] == "collectives" == want.checks[-1]


# -- the injectors through a strict build -------------------------------------

@pytest.mark.parametrize("name, exc, check", INJECTORS,
                         ids=[i[0] for i in INJECTORS])
def test_injected_defects_rejected_before_any_pack(name, exc, check):
    """Every static-defect class dies in from_csr(health="strict") with the
    reference's check, step and lane, and nothing was packed or launched
    (PACKS and LAUNCHES unchanged)."""
    from repro.core import faults as ref_faults
    from repro.solver import TriangularOperator as RefOperator
    L = generators.banded(n=200, bandwidth=5, seed=7)
    packs, launches = dict(K.PACKS), dict(K.LAUNCHES)
    with getattr(faults, name)() as count:
        with pytest.raises(exc) as ei:
            TriangularOperator.from_csr(L, "avgLevelCost", cache=False,
                                        health="strict", device="cpu")
        assert count["calls"] >= 1
    assert dict(K.PACKS) == packs and dict(K.LAUNCHES) == launches
    assert ei.value.check == check
    if exc is ScheduleInvariantError:
        assert ei.value.step >= 0 and ei.value.lane >= 0
    RefOperator.clear_memory_cache()
    with getattr(ref_faults, name)():
        want = _raised(lambda: RefOperator.from_csr(
            L, "avgLevelCost", cache=False, health="strict"))
    assert _fields(ei.value)[1:] == want[1:]


def test_defect_solves_finite_but_wrong_without_the_verifier():
    """The threat is real on the plain path: with the checks off, a
    reordered schedule solves to a finite, wrong answer."""
    L = generators.banded(n=200, bandwidth=5, seed=7)
    b = np.random.default_rng(0).standard_normal(L.n_rows)
    with faults.reorder_schedule_step():
        op = TriangularOperator.from_csr(L, "no_rewriting", cache=False,
                                         health="off", device="cpu")
        x = np.asarray(op.solve(b, health="off", max_refine=0))
    assert np.isfinite(x).all()
    assert np.abs(x - solve_csr_seq(L, b)).max() > 1e-3


# -- strict wiring ------------------------------------------------------------

def _count_verifier(monkeypatch):
    """Counts every schedule and packed-form certification."""
    count = {"schedule": 0, "packed": 0}
    real_sched, real_packed = V.verify_level_schedule, \
        V.verify_packed_schedule

    def sched(*a, **k):
        count["schedule"] += 1
        return real_sched(*a, **k)

    def packed(*a, **k):
        count["packed"] += 1
        return real_packed(*a, **k)

    monkeypatch.setattr(V, "verify_level_schedule", sched)
    monkeypatch.setattr(V, "verify_packed_schedule", packed)
    return count


def test_strict_build_certifies_once_and_the_tiers_carry_it(tmp_path,
                                                            monkeypatch):
    count = _count_verifier(monkeypatch)
    L = generators.banded(n=200, bandwidth=5, seed=9)
    kw = dict(cache_dir=tmp_path, health="strict", device="cpu")
    op = TriangularOperator.from_csr(L, "no_rewriting", **kw)
    cert = op.certificate
    assert cert is not None and cert.steps == op.schedule.num_steps
    assert count == {"schedule": 1, "packed": 0}   # no pack on the CPU
    # a memory hit reuses the certificate: the verifier runs 0 times
    op2 = TriangularOperator.from_csr(L, "no_rewriting", **kw)
    assert op2.stats.cache_source == "memory"
    assert op2.certificate is cert
    # so does a disk hit: the certificate was kept before the store
    TriangularOperator.clear_memory_cache()
    op3 = TriangularOperator.from_csr(L, "no_rewriting", **kw)
    assert op3.stats.cache_source == "disk"
    assert op3.certificate == cert
    assert count == {"schedule": 1, "packed": 0}
    # a hit built without strict health is certified at its first strict use
    L2 = generators.banded(n=150, bandwidth=4, seed=2)
    TriangularOperator.from_csr(L2, "no_rewriting", cache_dir=tmp_path,
                                device="cpu")
    op4 = TriangularOperator.from_csr(L2, "no_rewriting", **kw)
    assert op4.stats.cache_source == "memory" and op4.certificate is not None
    assert count == {"schedule": 2, "packed": 0}


def test_default_build_skips_verification_and_verify_certifies(tmp_path):
    L = generators.banded(n=150, bandwidth=4, seed=2)
    op = TriangularOperator.from_csr(L, "no_rewriting", cache_dir=tmp_path,
                                     device="cpu")
    assert op.certificate is None
    assert op._payload.get("packed_certificate") is None
    cert = op.verify(devices=2)
    assert op.certificate is cert and cert.devices == 2
    assert cert.collective_families is None
    cert = op.verify(collectives=True)      # a mesh of one rank
    assert cert.collective_families == op.schedule.num_steps


def test_update_values_strict_rejects_a_poisoned_rebind(tmp_path):
    L = generators.banded(n=200, bandwidth=5, seed=4)
    op = TriangularOperator.from_csr(L, "avgLevelCost", cache_dir=tmp_path,
                                     health="strict", device="cpu")
    b = np.random.default_rng(1).standard_normal(L.n_rows)
    L2 = L.with_data(L.data * 1.7)
    op.update_values(L2, health="strict")
    x = np.asarray(op.solve(b))
    assert np.abs(x - solve_csr_seq(L2, b)).max() < 1e-3
    packs = dict(K.PACKS)
    with faults.corrupt_values_payload() as count:
        with pytest.raises(ScheduleInvariantError) as ei:
            op.update_values(L.with_data(L.data * 0.5), health="strict")
    assert count["calls"] >= 1 and dict(K.PACKS) == packs
    assert ei.value.check in ("finite", "dinv")
    assert op.stats.value_updates == 1
    x2 = np.asarray(op.solve(b))            # still bound to L2's values
    assert np.abs(x2 - solve_csr_seq(L2, b)).max() < 1e-3


# -- the packed form: acceptance ----------------------------------------------

def _arrow(k=5000, seed=5):
    """Rows 0..k-1 hold only their diagonal, row k reads all of them (more
    than FAR_DEPS: its pairs go to `far`), row k + 1 reads row k and every
    97th of the first k."""
    rng = np.random.default_rng(seed)
    tail = np.arange(0, k, 97)
    rows = np.concatenate([np.full(k, k), np.full(tail.size + 1, k + 1)])
    cols = np.concatenate([np.arange(k), tail, [k]])
    vals = rng.uniform(-1, 1, rows.size) / np.sqrt(k)
    n = k + 2
    return from_coo(np.concatenate([rows, np.arange(n)]),
                    np.concatenate([cols, np.arange(n)]),
                    np.concatenate([vals, 1 + rng.random(n)]), (n, n))


def _arrow_sched():
    L = _arrow()
    ts = transform(L, make_strategy("no_rewriting"), validate=False)
    return schedule_for_transformed(ts, chunk=256, max_deps=16)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_packed_forms_certify(case, strategy):
    _, ts, sched = _build(case, strategy)
    packed = K.pack_schedule(sched)
    cert = verify_packed_schedule(packed, sched)
    assert cert.steps == packed.num_steps and cert.tiles == packed.num_tiles
    assert cert.lanes == sched.n == packed.num_lanes
    assert cert.free_rows == packed.num_free
    assert cert.checks == V.PACKED_CHECKS
    assert verify_packed_values(packed, sched).checks == \
        V.PACKED_VALUE_CHECKS
    gen, chunk, max_deps = CASES[case]
    psched, _, _ = schedule_for_preamble(ts, chunk=chunk, max_deps=max_deps)
    if psched is not None:
        verify_level_schedule(psched, None, np.ones(psched.n))
        verify_packed_schedule(K.pack_schedule(psched), psched)


def test_arrow_with_far_pairs_certifies():
    sched = _arrow_sched()
    packed = K.pack_schedule(sched)
    cert = verify_packed_schedule(packed, sched)
    assert cert.far_pairs == 5000 and cert.long_lanes == 2
    verify_packed_values(packed, sched)


# -- the packed form: hand-made mutations -------------------------------------

def _retile(packed, tiles):
    """`packed` with its tile stream made of the word arrays `tiles`."""
    ptr = np.concatenate([[0], np.cumsum([t.size // 4 for t in tiles])])
    return dataclasses.replace(
        packed, tiles=torch.from_numpy(np.concatenate(tiles)),
        tile_ptr=torch.from_numpy(ptr.astype(np.int32)))


def _tile_words(packed):
    w = packed.tiles.numpy()
    tp = 4 * packed.tile_ptr.numpy().astype(np.int64)
    return [w[a:b].copy() for a, b in zip(tp[:-1], tp[1:])]


def _record(lane):
    """Word offset of a lane's record in its tile."""
    return K.HEADER_WORDS + K.LANE_WORDS * lane


def _lung2_pack():
    _, _, sched = _build("lung2_like(0.05)", "no_rewriting")
    return sched, K.pack_schedule(sched)


def _swapped_step(packed):
    tiles = _tile_words(packed)
    tiles[0], tiles[-1] = tiles[-1], tiles[0]
    return _retile(packed, tiles)


def _oob_dep(packed):
    tiles = _tile_words(packed)
    t = next(i for i, tw in enumerate(tiles)
             if tw[_record(0) + 3] & 0x7FFFFFFF)
    tw = tiles[t]
    tw[tw[_record(0) + 2]] = packed.n + 3
    return _retile(packed, tiles)


def _cleared_last(packed):
    tiles = _tile_words(packed)
    t = next(i for i, tw in enumerate(tiles) if tw[2] & 2 and
             (tw[K.HEADER_WORDS + 3:K.HEADER_WORDS + K.LANE_WORDS * tw[0]:
                 K.LANE_WORDS] < 0).sum() > 1)
    tw = tiles[t]
    recs = tw[K.HEADER_WORDS + 3:K.HEADER_WORDS + K.LANE_WORDS * tw[0]:
              K.LANE_WORDS]
    lane = int(np.flatnonzero(recs < 0)[0])
    tw[_record(lane) + 3] &= 0x7FFFFFFF
    return _retile(packed, tiles)


def _flipped_last_in_wide_tile(packed):
    tiles = _tile_words(packed)
    t = next(i for i, tw in enumerate(tiles) if not tw[2] & 2 and tw[0] > 1)
    tw = tiles[t]
    tw[_record(0) + 3] ^= np.int32(-2**31)
    return _retile(packed, tiles)


def _bad_coefficient(packed):
    tiles = _tile_words(packed)
    tw = next(tw for tw in tiles if tw[_record(0) + 3] & 0x7FFFFFFF)
    tw[tw[_record(0) + 2] + 1] = np.float32(0.25).view(np.int32)
    return _retile(packed, tiles)


def _dropped_free_row(packed):
    return dataclasses.replace(packed, free_row=packed.free_row[1:],
                               free_dinv=packed.free_dinv[1:])


def _bad_dinv(packed):
    tiles = _tile_words(packed)
    tw = tiles[len(tiles) // 2]
    tw[_record(0) + 1] = np.float32(3.0).view(np.int32)
    return _retile(packed, tiles)


def _far_out_of_range(packed):
    tiles = _tile_words(packed)
    for tw in tiles:
        offs = tw[K.HEADER_WORDS + 2:K.HEADER_WORDS + K.LANE_WORDS * tw[0]:
                  K.LANE_WORDS]
        hit = np.flatnonzero(offs < 0)
        if hit.size:
            tw[_record(int(hit[0])) + 2] = ~np.int32(packed.far.numel())
            return _retile(packed, tiles)
    raise AssertionError("no lane reads far")


def _remapped(packed, **fields):
    return dataclasses.replace(packed, values=dataclasses.replace(
        packed.values, **fields))


def _permuted_value_map(packed):
    tw = packed.values.tile_word.copy()
    tw[[0, -1]] = tw[[-1, 0]]
    return _remapped(packed, tile_word=tw)


def _value_map_onto_an_index_word(packed):
    tw = packed.values.tile_word.copy()
    tw[0] -= 1                      # a coefficient word's index word
    return _remapped(packed, tile_word=tw)


PACKED_MUTATIONS = {
    "permuted value map": (_permuted_value_map, "value-map"),
    "value map onto an index word": (_value_map_onto_an_index_word,
                                     "value-map"),
    "swapped step": (_swapped_step, "race"),
    "out-of-range dep index": (_oob_dep, "index-bounds"),
    "cleared last bit in a narrow run": (_cleared_last, "race"),
    "flipped last bit in a wide tile": (_flipped_last_in_wide_tile,
                                        "shape"),
    "row dropped from the free pass": (_dropped_free_row, "bijection"),
    "bad dinv word": (_bad_dinv, "dinv"),
    "bad coefficient word": (_bad_coefficient, "deps"),
}


@pytest.mark.parametrize("name", sorted(PACKED_MUTATIONS))
def test_packed_mutations_are_refused_with_their_check(name):
    sched, packed = _lung2_pack()
    mutate, check = PACKED_MUTATIONS[name]
    with pytest.raises(ScheduleInvariantError) as ei:
        verify_packed_schedule(mutate(packed), sched)
    assert ei.value.check == check
    if check in ("race", "index-bounds", "dinv", "deps"):
        assert ei.value.step >= 0 and ei.value.lane >= 0


def test_far_offset_out_of_range_is_refused():
    sched = _arrow_sched()
    packed = K.pack_schedule(sched)
    with pytest.raises(ScheduleInvariantError) as ei:
        verify_packed_schedule(_far_out_of_range(packed), sched)
    assert ei.value.check == "index-bounds"
    assert "far" in str(ei.value)


def test_packed_values_refuse_a_word_the_refresh_did_not_write():
    sched, packed = _lung2_pack()
    new = faults.scale_schedule(sched, 1.5)
    fresh, repacked = K.refresh_packed_values(packed, new)
    assert not repacked
    verify_packed_values(fresh, new)
    with pytest.raises(ScheduleInvariantError) as ei:
        verify_packed_values(packed, new)           # the old values
    assert ei.value.check == "dinv"
    zeroed = dataclasses.replace(sched, groups=tuple(
        dataclasses.replace(g, dep_coef=np.zeros_like(g.dep_coef))
        for g in sched.groups))
    with pytest.raises(ScheduleInvariantError) as ei:
        verify_packed_values(fresh, zeroed)
    assert ei.value.check == "zero-set"


# -- the card's certification flow, on host packs -----------------------------

def test_card_flow_certifies_packed_forms_before_the_store():
    """What from_csr and update_values do on a card under strict health,
    run on host packs: the main and preamble schedules' packed forms get
    full certificates; a device value refresh gets the value checks, a
    re-pack a full one."""
    L = generators.lung2_like(0.05)
    op = TriangularOperator.from_csr(L, "avgLevelCost", cache=False,
                                     health="strict", device="cpu")
    payload = op._payload
    packs = K.PACKS["pack_groups"]
    _certify(payload, torch.device("cuda"), "here")
    assert K.PACKS["pack_groups"] == packs + 2         # main and preamble
    certs = payload["packed_certificate"]
    assert certs["packed"].steps == payload["packed"].num_steps
    assert certs["preamble_packed"].steps == \
        payload["preamble_packed"].num_steps
    _certify(payload, torch.device("cuda"), "here")    # nothing left to do
    assert K.PACKS["pack_groups"] == packs + 2
    rows = np.repeat(np.arange(L.n_rows), L.row_nnz())
    L2 = L.with_data(np.where(rows != L.indices, L.data * 1.3, L.data))
    new, repacked = TriangularOperator._derive_payload(payload, L2,
                                                       certify=True)
    _certify(new, torch.device("cuda"), "here", base=payload,
             refreshed=repacked)
    for which, again in repacked.items():
        checks = new["packed_certificate"][which].checks
        assert checks == (V.PACKED_CHECKS if again else
                          V.PACKED_VALUE_CHECKS)
    # a form refreshed from one that was never certified is certified in
    # full: the value read-back stands on a certified value map
    uncertified = dict(payload, packed_certificate=None)
    new, repacked = TriangularOperator._derive_payload(uncertified, L2)
    _certify(new, torch.device("cuda"), "here", base=uncertified,
             refreshed=repacked)
    assert all(c.checks == V.PACKED_CHECKS
               for c in new["packed_certificate"].values())
    with faults.corrupt_values_payload():
        with pytest.raises(ScheduleInvariantError):
            TriangularOperator._derive_payload(payload, L2, certify=True)


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name, exc, check", INJECTORS,
                         ids=[i[0] for i in INJECTORS])
def test_cuda_injected_defects_rejected_before_any_pack(cuda_device, name,
                                                        exc, check):
    L = generators.banded(n=200, bandwidth=5, seed=7)
    packs, launches = dict(K.PACKS), dict(K.LAUNCHES)
    with getattr(faults, name)():
        with pytest.raises(exc) as ei:
            TriangularOperator.from_csr(L, "avgLevelCost", cache=False,
                                        health="strict", device=cuda_device)
    assert dict(K.PACKS) == packs and dict(K.LAUNCHES) == launches
    assert ei.value.check == check


@pytest.mark.cuda
def test_cuda_strict_build_certifies_what_the_kernel_reads(cuda_device):
    L = generators.lung2_like(0.05)
    op = TriangularOperator.from_csr(L, "avgLevelCost", cache=False,
                                     health="strict", device=cuda_device)
    certs = op._payload.get("packed_certificate")
    assert certs["packed"].steps == op._staged().packed().num_steps
    assert certs["preamble_packed"] is not None
    b = np.random.default_rng(3).standard_normal(L.n_rows)
    x = op.solve(b, max_refine=0, health="strict")
    assert np.abs(x - solve_csr_seq(L, b)).max() < 5e-4 * max(
        1.0, np.abs(x).max())
    rows = np.repeat(np.arange(L.n_rows), L.row_nnz())
    L2 = L.with_data(np.where(rows != L.indices, L.data * 1.01, L.data))
    op.update_values(L2, health="strict")
    assert op._payload["packed_certificate"]["packed"].checks in (
        V.PACKED_CHECKS, V.PACKED_VALUE_CHECKS)


@pytest.mark.cuda
def test_cuda_unverified_race_fails_in_the_packing(cuda_device):
    L = generators.banded(n=200, bandwidth=5, seed=7)
    with faults.reorder_schedule_step():
        with pytest.raises(ValueError, match="no earlier step"):
            TriangularOperator.from_csr(L, "no_rewriting", cache=False,
                                        health="off", device=cuda_device)
