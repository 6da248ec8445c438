"""The port's numpy host half is a faithful copy of the reference's.

The same seeds give the same CSR arrays from `repro_torch.sparse.generators`
as from `repro.sparse.generators`, and the copied transform + schedule
compiler give transformed systems and LevelSchedules whose every array is
equal (exactly, not within a tolerance) to the reference's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.portfolio import make_strategy as ref_make_strategy
from repro.core.transform import transform as ref_transform
from repro.solver import schedule as ref_schedule
from repro.sparse import build_levels as ref_build_levels
from repro.sparse import generators as ref_gen

from repro_torch.core.portfolio import make_strategy
from repro_torch.core.transform import transform
from repro_torch.solver import schedule
from repro_torch.sparse import build_levels
from repro_torch.sparse import generators as gen

torch.set_num_threads(1)

MATRICES = {
    "lung2_like(0.05)": lambda g: g.lung2_like(0.05),
    "torso2_like(0.04)": lambda g: g.torso2_like(0.04),
    "banded(96,10)": lambda g: g.banded(96, 10, seed=2),
    "random_lower(300)": lambda g: g.random_lower(300, avg_offdiag=3.0,
                                                  seed=5),
}
GROUP_ARRAYS = ("row_ids", "dep_idx", "dep_coef", "dinv", "carry_in",
                "carry_out")


def assert_csr_equal(a, b):
    assert a.shape == b.shape
    for name in ("indptr", "indices", "data"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def assert_schedules_equal(port, ref):
    assert port.n == ref.n
    assert port.n_carry == ref.n_carry
    assert port.num_steps == ref.num_steps
    assert port.num_levels == ref.num_levels
    assert port.group_widths == ref.group_widths
    for gp, gr in zip(port.groups, ref.groups, strict=True):
        for name in GROUP_ARRAYS:
            x, y = getattr(gp, name), getattr(gr, name)
            if y is None:
                assert x is None, name
                continue
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_generators_match(name):
    assert_csr_equal(MATRICES[name](gen), MATRICES[name](ref_gen))


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_levels_match(name):
    lp, lr = build_levels(MATRICES[name](gen)), \
        ref_build_levels(MATRICES[name](ref_gen))
    np.testing.assert_array_equal(lp.level_of, lr.level_of)
    np.testing.assert_array_equal(lp.order, lr.order)
    np.testing.assert_array_equal(lp.level_ptr, lr.level_ptr)


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("strategy", ["no_rewriting", "avgLevelCost",
                                      "manual_every_k"])
@pytest.mark.parametrize("name", ["lung2_like(0.05)", "torso2_like(0.04)",
                                  "banded(96,10)"])
def test_transformed_schedules_match(name, strategy, compact):
    max_deps = 4 if name.startswith("banded") else 8   # banded: split rows
    ts = transform(MATRICES[name](gen), make_strategy(strategy),
                   validate=False)
    ts_ref = ref_transform(MATRICES[name](ref_gen),
                           ref_make_strategy(strategy), validate=False,
                           codegen=False)
    assert_csr_equal(ts.A, ts_ref.A)
    assert_csr_equal(ts.T, ts_ref.T)
    np.testing.assert_array_equal(ts.src, ts_ref.src)
    np.testing.assert_array_equal(ts.diag, ts_ref.diag)
    np.testing.assert_array_equal(ts.level_of_recomputed,
                                  ts_ref.level_of_recomputed)
    assert dataclasses.asdict(ts.metrics) == \
        dataclasses.asdict(ts_ref.metrics)
    kw = dict(chunk=64, max_deps=max_deps, compact=compact)
    assert_schedules_equal(schedule.schedule_for_transformed(ts, **kw),
                           ref_schedule.schedule_for_transformed(ts_ref,
                                                                 **kw))
    pre = schedule.schedule_for_preamble(ts, **kw)
    pre_ref = ref_schedule.schedule_for_preamble(ts_ref, **kw)
    if pre_ref[0] is None:
        assert pre == (None, None, None)
    else:
        assert_schedules_equal(pre[0], pre_ref[0])
        np.testing.assert_array_equal(pre[1], pre_ref[1])
        np.testing.assert_array_equal(pre[2], pre_ref[2])


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_csr_schedules_match(name, compact):
    L, L_ref = MATRICES[name](gen), MATRICES[name](ref_gen)
    kw = dict(chunk=32, max_deps=4, compact=compact)
    assert_schedules_equal(
        schedule.schedule_for_csr(L, build_levels(L), **kw),
        ref_schedule.schedule_for_csr(L_ref, ref_build_levels(L_ref), **kw))


def test_transform_codegen_not_ported():
    with pytest.raises(NotImplementedError, match="codegen"):
        transform(gen.chain(8), make_strategy("no_rewriting"), codegen=True)
